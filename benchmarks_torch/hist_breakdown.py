#!/usr/bin/env python3
"""Where the CUDA histogram kernel's time goes, on one card.

    python3 benchmarks_torch/hist_breakdown.py [--out FILE]
    python3 benchmarks_torch/hist_breakdown.py --src OTHER/src [--out FILE]

Builds variants of ``src/repro_torch/kernels/hsv_features/csrc/hist.cu``,
each with one piece of work taken out by a text edit of the source (so
every variant but ``full`` computes wrong outputs: they are timed, never
used), and times each through ``kernel.hsv_hist_batch`` in the five cases
of ``chip_smoke.py``'s hist phase (``chip_smoke.hist_weights``: 64 frames
of 720x1280, two colors; the 5.7 % ``batch_foreground`` mask as bool and
as float 0/1, an all-true mask, uniform (0, 1] and dyadic k/8 weights).
Per case: a call's ms (CUDA events, the wrapper's host work included)
and the device ms and device launches of one call (``torch.profiler``,
every kernel the call launches); all variants in one process, on one
card.

Variants:
  full          the kernel as committed (held to the plain version)
  no_hsv        RGB->HSV replaced by three copies
  no_hist       no histogram update: the bin and hue test feed a
                register sum instead of the counters
  skeleton      the memory skeleton: weights and the RGB of non-zero
                pixels loaded as ``full`` loads them, summed, no pixel work
  weights_only  the weights alone: no RGB load and no pixel work
  launch_only   no pixel loop: the launch, the zeroing, the partials, the
                tickets and the last blocks' sums
  no_rgb_load   RGB made from the pixel index instead of loaded: the
                pixel loop alone, on other data (the branches differ)
  no_queue      every step with a non-zero weight works in place (no
                per-warp queue for sparse steps)
  branchy_hue   the hue's three-way choice on the maximum channel made
                by branches in place of ``rgb_to_hsv``'s selects (the
                same operations and roundings)
  key_per_color the float combine run once a color for every pixel, not
                once with one key a pixel

With ``--src``, the package under that directory (another tree's
``src``, for example the parent commit's from ``git archive``) is timed
instead, as committed and without variants, in the same five cases.

Prints one JSON line per variant and writes them all to ``--out``
(default ``results/hist_breakdown.json``). Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/hsv_features/csrc"

_NO_WORK = ("    load_rgb<FLOAT>(fr, i0, p.N, vec_rgb, q, px);\n",
            "    load_rgb<FLOAT>(fr, i0, p.N, vec_rgb, q, px);\n"
            "    for (int j = 0; j < 3 * QUAD; ++j) fsum += px[j];\n"
            "    fn += (int)fsum;\n    return;\n")
_FLOAT_UPDATE = (
    "        if (!__any_sync(0xffffffffu, (cm & (cm - 1u)) != 0u)) {\n"
    "            warp_add(sh.whist[warp], cm ? (__ffs(cm) - 1) * nb + joint"
    " : -1,\n"
    "                     w, lane);\n"
    "        } else {\n"
    "#pragma unroll\n"
    "            for (int k = 0; k < MAX_COLORS; ++k)\n"
    "                if (k < p.nc)\n"
    "                    warp_add(sh.whist[warp],\n"
    "                             (cm >> k) & 1u ? k * nb + joint : -1, w,"
    " lane);\n"
    "        }\n")
_BRANCHY_HSV = (
    "v = fmaxf(fmaxf(r, g), b);\n"
    "        const float cr = v - fminf(fminf(r, g), b);\n"
    "        s = v > 0.0f ? cr / fmaxf(v, 1e-9f) * 255.0f : 0.0f;\n"
    "        const float sc = cr > 0.0f ? cr : 1.0f;\n"
    "        if (v == r) h = floor_mod6((g - b) / sc);\n"
    "        else if (v == g) h = (b - r) / sc + 2.0f;\n"
    "        else h = (r - g) / sc + 4.0f;\n"
    "        h = cr > 0.0f ? h * 30.0f : 0.0f;")
VARIANTS = {
    "full": [],
    "no_hsv": [("rgb_to_hsv(r, g, b, h, s, v);",
                "h = r; s = g; v = b;")],
    "no_hist": [("atomicAdd(&sh.counts[k * nb + joint], 1);",
                 "fn += k * nb + joint;"),
                (_FLOAT_UPDATE, "        fsum += (float)(cm + joint);\n")],
    "skeleton": [_NO_WORK],
    "weights_only": [("    if (n == 0) return;\n",
                      "    fsum += (float)n;\n    fn += n;\n    return;\n")],
    "launch_only": [("for (int c0 = g; c0 < nch; c0 += U * G)",
                     "for (int c0 = g; c0 < 0; c0 += U * G)")],
    "no_rgb_load": [("    const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};\n",
                     "    const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};\n"
                     "    if (N > 0) {\n#pragma unroll\n"
                     "        for (int j = 0; j < 3 * QUAD; ++j)\n"
                     "            px[j] = (float)(((i0 + j / 3)"
                     " * (7 + 6 * (j % 3))) & 255);\n"
                     "        return;\n    }\n")],
    "no_queue": [("#define DIRECT (3 * 32)", "#define DIRECT 0")],
    "branchy_hue": [("rgb_to_hsv(r, g, b, h, s, v);", _BRANCHY_HSV)],
    "key_per_color": [(_FLOAT_UPDATE,
                       "#pragma unroll\n"
                       "        for (int k = 0; k < MAX_COLORS; ++k)\n"
                       "            if (k < p.nc)\n"
                       "                warp_add("
                       "sh.whist[warp],\n"
                       "                         (cm >> k) & 1u ? "
                       "k * nb + joint : -1, w, lane);\n")],
}


def build(kbuild, tmp: Path) -> dict:
    """One nvcc per variant, all started together; {name: (CDLL, ptxas)}."""
    src = (CSRC / "hist.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in hist.cu")
            text = text.replace(old, new)
        cu = tmp / f"hist_{name}.cu"
        cu.write_text(text)
        so = tmp / f"hist_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.HSV_FLAGS, "-I", str(CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        usage = {e: u for e, u in kbuild.ptxas_usage(log).items()
                 if "hist_kernel" in e}
        out[name] = (ctypes.CDLL(str(so)), usage)
    return out


def device_per_call(fn, runs: int = 5, sessions: int = 3):
    """(device ms, device launches) of one call: every device kernel's
    time and launches in a profiled window of ``runs`` calls, over
    ``runs``; (None, None) when no session delivered a device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (e.self_device_time_total or 0) > 0]
        if rows:
            return (sum(e.self_device_time_total for e in rows) / 1e3 / runs,
                    sum(e.count for e in rows) / runs)
    return None, None


def time_cases(cs, kernel, rgb, cases, hr) -> dict:
    out = {}
    for label, w in cases.items():
        def call():
            return kernel.hsv_hist_batch(rgb, w, hr)
        dev_ms, launches = device_per_call(call)
        out[label] = {"ms": cs.cuda_ms(call, runs=20), "device_ms": dev_ms,
                      "device_launches_per_call": launches}
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "hist_breakdown.json"))
    ap.add_argument("--src", default=None,
                    help="time the package under this directory as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_breakdown: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.colors import RED, YELLOW
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.hsv_features import kernel, ref

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    hr = (tuple(RED.hue_ranges), tuple(YELLOW.hue_ranges))
    small, _ = cs.scenes(1000, cs.TRAIN + cs.STEPS * cs.T)
    rgb, fg = cs.hist_inputs(dev, cs.upsampler(torch.as_tensor(small,
                                                               device=dev)))
    cases = cs.hist_weights(fg)
    kbuild.build()
    results = {}
    if args.src:
        rec = {"variant": "as_committed", "src": str(src),
               **time_cases(cs, kernel, rgb, cases, hr)}
        results["as_committed"] = rec
        print(json.dumps(rec), flush=True)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            libs = build(kbuild, Path(tmp))
        for name, (lib, usage) in libs.items():
            kbuild.BUILD.libs["hist"] = lib      # the wrapper launches it
            kernel._RESIDENT.clear()
            rec = {"variant": name, "ptxas": usage,
                   "resident_blocks": kernel.resident_blocks(dev, "hist"),
                   **time_cases(cs, kernel, rgb, cases, hr)}
            if name == "full":
                for label, w in cases.items():
                    got = kernel.hsv_hist_batch(rgb, w, hr)
                    rec[label]["max_abs_err"] = kernel.compare_hist_with_plain(
                        got, ref.hsv_hist_ref(rgb, w, hr), w)["max_abs_err"]
            results[name] = rec
            print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"device": smi, "shape": list(rgb.shape), "variants": results},
        indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
