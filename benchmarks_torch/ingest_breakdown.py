#!/usr/bin/env python3
"""Where the CUDA ingest kernel's time goes, on one card.

    python3 benchmarks_torch/ingest_breakdown.py [--out FILE]

Builds variants of ``src/repro_torch/kernels/hsv_features/csrc/ingest.cu``,
each with one piece of work taken out by a text edit of the source (so
every variant but ``full`` computes wrong outputs: they are timed, never
used), and times each through ``kernel.ingest_batch`` at the serve shape
(8 cameras x 8 frames of 720x1280, two colors, a static scene with a
moving band, so about 8 % of the pixels are foreground). Device time per
call from ``torch.profiler``; all variants in one process, on one card.

Variants:
  full          the kernel as committed
  normal_l2     both L2 policies evict_normal (no evict-first RGB, no
                evict-last background lane)
  no_hsv        RGB->HSV replaced by three copies
  no_fg_work    the foreground branch (joint bin, hue test, histogram
                atomics, bounding box) never taken
  copy          no per-pixel work at all: the background becomes the sum
                of the inputs (the memory skeleton)
  copy_rgb_only ``copy`` with the background lane read at frame 0 and
                written at the last frame only (the RGB stream alone)
  barrier_only  no item and no finalize work: the launch, the zeroing and
                the T+1 grid barriers; its T=1 and T=17 times give one
                barrier's cost

Prints one JSON line per variant and writes them all to ``--out``
(default ``results/ingest_breakdown.json``). Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/hsv_features/csrc"
C, T, H, W, UP = 8, 8, 90, 160, 8

_COPY = [("    float h, s, v;\n    rgb_to_hsv(r, gg, b, h, s, v);",
          "    return base + r + gg + b;\n"
          "    float h, s, v;\n    rgb_to_hsv(r, gg, b, h, s, v);")]
_NORMAL = [("createpolicy.fractional.L2::evict_last.b64",
            "createpolicy.fractional.L2::evict_normal.b64"),
           ("createpolicy.fractional.L2::evict_first.b64",
            "createpolicy.fractional.L2::evict_normal.b64")]
_LANE_ENDS_ONLY = [
    ("for (int u = lane; !seed && u < n4 / 4; u += 32)",
     "for (int u = lane; t == 0 && !seed && u < n4 / 4; u += 32)"),
    ("        st_hint(row + i, ingest_pixel<BBOX>(p, i, r, gg, b, base, "
     "seed, g, nb,\n                                            s_counts, "
     "hues, a),\n                keep);",
     "        const float out = ingest_pixel<BBOX>(p, i, r, gg, b, base, "
     "seed, g, nb, s_counts, hues, a);\n"
     "        if (t == p.T - 1) st_hint(row + i, out, keep);")]
VARIANTS = {
    "full": [],
    "normal_l2": _NORMAL,
    "no_hsv": [("    rgb_to_hsv(r, gg, b, h, s, v);",
                "    h = r; s = gg; v = b;")],
    "no_fg_work": [("    if (fg) {\n        a.fg += 1;",
                    "    if (fg && p.N < 0) {\n        a.fg += 1;")],
    "copy": _COPY,
    "copy_rgb_only": _COPY + _LANE_ENDS_ONLY,
    "barrier_only": [("it < nitems; it += gridDim.x", "it < 0; it += 1"),
                     ("f < nframes; f += gridDim.x", "f < 0; f += 1")],
}


def build(kbuild, tmp: Path) -> dict:
    """One nvcc per variant, all started together; {name: (CDLL, ptxas)}."""
    src = (CSRC / "ingest.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in ingest.cu")
            text = text.replace(old, new)
        cu = tmp / f"ingest_{name}.cu"
        cu.write_text(text)
        so = tmp / f"ingest_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.HSV_FLAGS, "-I", str(CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        usage = [u for e, u in kbuild.ptxas_usage(log).items()
                 if "ingest_kernel" in e]
        out[name] = (ctypes.CDLL(str(so)), usage)
    return out


def device_ms(fn, runs: int = 5, sessions: int = 3):
    """Mean device time of one call's ingest kernel (torch.profiler)."""
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
        got = [e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "ingest_kernel" in e.key and e.self_device_time_total]
        if got:
            return got[0]
    return None


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "ingest_breakdown.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ingest_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.colors import RED, YELLOW
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.hsv_features import kernel, ref

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    kbuild.build()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(kbuild, Path(tmp))
    hr = (tuple(RED.hue_ranges), tuple(YELLOW.hue_ranges))
    rng = np.random.default_rng(0)
    N = H * UP * W * UP
    small = rng.uniform(0, 255, (C, T + 1, H, W, 3)).astype(np.float32)
    small[:, :] = small[:, :1]
    small[:, :, 40:50] = rng.uniform(0, 255, (C, T + 1, 10, W, 3))
    big = torch.as_tensor(small, device=dev).repeat_interleave(
        UP, 2).repeat_interleave(UP, 3).reshape(C, T + 1, N, 3)
    rgb, bg0 = big[:, 1:].contiguous(), big[:, 0].amax(-1).contiguous()
    del big
    gain0 = torch.ones(C, device=dev)
    M = torch.as_tensor(rng.uniform(0, 1, (2, 64)).astype(np.float32),
                        device=dev)
    norm = torch.ones(2, device=dev)
    want = ref.ingest_batch_ref(rgb, bg0, gain0, M, norm, hr)
    results = {}
    for name, (lib, usage) in libs.items():
        kbuild.BUILD.libs["ingest"] = lib      # the wrapper launches it
        kernel._RESIDENT.clear()
        call = (rgb, bg0, gain0, M, norm, hr)
        got = kernel.ingest_batch(*call)
        torch.cuda.synchronize()
        rec = {"variant": name, "ptxas": usage,
               "resident_blocks": kernel.resident_blocks(dev),
               "device_ms": device_ms(lambda: kernel.ingest_batch(*call))}
        if name == "full":
            rec["max_abs_err"] = kernel.compare_with_plain(
                got, want, M, norm)["max_abs_err"]
            rec["foreground_share"] = float(got[2].sum() / (C * T * N))
        if name == "barrier_only":
            one = (rgb[:, :1].contiguous(), bg0, gain0, M, norm, hr)
            many = (rgb[:, :1].expand(C, 17, N, 3).contiguous(), bg0, gain0,
                    M, norm, hr)
            d1 = device_ms(lambda: kernel.ingest_batch(*one))
            d17 = device_ms(lambda: kernel.ingest_batch(*many))
            rec.update(device_ms_t1=d1, device_ms_t17=d17,
                       barrier_us=(d17 - d1) / 16 * 1e3
                       if d1 and d17 else None)
            del many
        del got
        results[name] = rec
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"device": smi, "shape": [C, T, N, 3], "variants": results},
        indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
