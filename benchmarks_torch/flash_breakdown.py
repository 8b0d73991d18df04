#!/usr/bin/env python3
"""Where the float32 CUDA flash attention kernel's time goes, on one card.

    python3 benchmarks_torch/flash_breakdown.py [--out FILE]
    python3 benchmarks_torch/flash_breakdown.py --src OTHER/src [--out FILE]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/flash.cu``,
each with one piece of the float32 kernel's work taken out by a text edit
of the source (so every variant but ``full`` and ``no_split`` computes
wrong outputs: they are timed, never used), and times each through
``kernel.flash_attention`` in float32 at ``chip_smoke.py``'s flash shapes:
(a) smollm-135m layer 0 (4 x 2048, 9/3 heads of 64, causal), (b)
gemma3-12b's local layer (1 x 4096, 16/8 heads of 256, window 1024), (c)
512 queries at the tail of 2048 keys (2 x 9/3 heads of 64) and the padded
S=2000 case as the kernel sees it (2 x 2048, 9/3 heads of 64, causal).
Inputs are seeded standard normals. Per case: a call's ms (CUDA events,
the wrapper's host work included), the device ms and device launches of
one call (``torch.profiler``, every kernel the call launches), the plan's
``n_split``, and the share of the float32 CUDA-core bound (67 TFLOP/s,
operations over the visible pairs) that the device time reaches; all
variants in one process, on one card.

Variants:
  full            the kernel as committed (held to the plain version)
  no_softmax      no online softmax: the masked raw scores go to P as
                  they are (no row max, no exp2, no rescale)
  no_pv           no PV product (the P^T stores and V copies stay)
  no_kv_loads     no K or V copies: the products run on whatever the
                  shared tiles hold (Q is still copied)
  sync_loads      Q, K and V copied by plain 16-byte loads and stores
                  where the kernel issues cp.async (each copy waits for
                  its load)
  mask_every_tile the element mask on every K tile, not only where the
                  diagonal, the window edge or Sk cuts it
  no_split        the kernel as committed with split-KV off
                  (``FLASH_SPLIT_WAVES = 0``: one block a q tile)

With ``--src``, the package under that directory (another tree's
``src``, for example the parent commit's from ``git archive``) is timed
instead, as committed and without variants, in the same cases.

Prints one JSON line per variant and writes them all to ``--out``
(default ``results/flash_breakdown.json``). Exits non-zero without a card.
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
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores, data sheet

# (B, Hq, Hkv, Sq, Sk, d, window), all causal: chip_smoke.py's flash cases
CASES = {
    "a_smollm_layer0": (4, 9, 3, 2048, 2048, 64, None),
    "b_gemma3_local": (1, 16, 8, 4096, 4096, 256, 1024),
    "c_tail": (2, 9, 3, 512, 2048, 64, None),
    "c_padded": (2, 9, 3, 2048, 2048, 64, None),
}

_SOFTMAX = ("for (int i = 0; i < TR; ++i) {\n                float mx = s[i][0];",
            "for (int i = 0; i < 0; ++i) {\n                float mx = s[i][0];")
_CP_ASYNC = ("flash_mma::cp_async16(dst + x * RPI * (HD + PAD) * 4,\n"
             "                              ok ? src + x * RPI * ss : safe, ok);",
             "const float4 f = ok ? *reinterpret_cast<const float4*>(\n"
             "            src + x * RPI * ss) : make_float4(0.f, 0.f, 0.f, 0.f);\n"
             "        asm volatile(\"st.shared.v4.f32 [%0], {%1, %2, %3, %4};\"\n"
             "                     :: \"r\"(dst + x * RPI * (HD + PAD) * 4),\n"
             "                        \"f\"(f.x), \"f\"(f.y), \"f\"(f.z), \"f\"(f.w)\n"
             "                     : \"memory\");")
VARIANTS = {
    "full": [],
    "no_softmax": [_SOFTMAX],
    "no_pv": [("for (int c = 0; c < BK; ++c) {",
               "for (int c = 0; c < 0; ++c) {")],
    "no_kv_loads": [
        ("load_rows<BK, HD>(Kd, k + b * p.k_sb + hk * p.k_sh\n"
         "                                  + (kt_lo * BK + lr) * p.k_ss + lc,\n"
         "                          p.k_ss, kt_lo * BK + lr, p.Sk, k);", ""),
        ("load_rows<BK, HD>(Vd, blk.vh + (k0 + lr) * p.v_ss + lc, p.v_ss,\n"
         "                              k0 + lr, p.Sk, v);", ""),
        ("load_rows<BK, HD>(Kd, blk.kh + (k0 + BK + lr) * p.k_ss + lc,\n"
         "                                  p.k_ss, k0 + BK + lr, p.Sk, k);",
         "{}")],
    "sync_loads": [_CP_ASYNC],
    "mask_every_tile": [("const bool edge =\n                k0 + BK > p.Sk",
                         "const bool edge = true ||\n                k0 + BK > p.Sk")],
}


def build(kbuild, tmp: Path) -> dict:
    """One nvcc per variant, all started together; {name: (CDLL, ptxas)}."""
    src = (CSRC / "flash.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in flash.cu")
            text = text.replace(old, new)
        cu = tmp / f"flash_{name}.cu"
        cu.write_text(text)
        so = tmp / f"flash_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.FLASH_FLAGS, "-I", str(CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        usage = {e: u for e, u in kbuild.ptxas_usage(log).items()
                 if "flash_kernel" in e}
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


def inputs(dev) -> dict:
    import numpy as np
    import torch
    rng = np.random.default_rng(6)
    out = {}
    for name, (B, Hq, Hkv, Sq, Sk, d, window) in CASES.items():
        def t(shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32), device=dev)
        out[name] = (t((B, Hq, Sq, d)), t((B, Hkv, Sk, d)),
                     t((B, Hkv, Sk, d)), window)
    return out


def time_cases(cs, fk, data, check: bool = False) -> dict:
    from repro_torch.kernels.flash_attention.ref import attention_ref
    out = {}
    for name, (q, k, v, window) in data.items():
        B, Hq, Sq, d = q.shape

        def call():
            return fk.flash_attention(q, k, v, causal=True, window=window,
                                      block_q=64, block_k=64)
        dev_ms, launches = device_per_call(call)
        ops = fk.attention_ops(B, Hq, Sq, k.shape[2], d, True, window)
        bound = ops / F32_OPS_PER_S * 1e3
        rec = {"ms": cs.cuda_ms(call, runs=10), "device_ms": dev_ms,
               "device_launches_per_call": launches,
               "f32_cuda_core_bound_ms": bound,
               "bound_share": bound / dev_ms if dev_ms else None}
        if hasattr(fk, "flash_plan"):
            rec["n_split"] = fk.flash_plan(
                B, Hq, Sq, k.shape[2], d, True, window,
                fk.resident_blocks(q.device, d)).n_split
        if check:
            err = (call() - attention_ref(q, k, v, causal=True,
                                          window=window)).abs().max()
            rec["max_abs_err"] = float(err)
        out[name] = rec
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results"
                                         / "flash_breakdown.json"))
    ap.add_argument("--src", default=None,
                    help="time the package under this directory as it is")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import kernel as fk

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    data = inputs(dev)
    kbuild.build()
    results = {}
    with torch.inference_mode():
        if args.src:
            usage = {e: u for e, u in kbuild.ptxas_usage(
                kbuild.BUILD.log).items() if "flash_kernel" in e}
            rec = {"variant": "as_committed", "src": str(src),
                   "ptxas": usage, **time_cases(cs, fk, data, check=True)}
            results["as_committed"] = rec
            print(json.dumps(rec), flush=True)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                libs = build(kbuild, Path(tmp))
            for name, (lib, usage) in libs.items():
                kbuild.BUILD.libs["flash"] = lib   # the wrapper launches it
                fk._RESIDENT.clear()
                rec = {"variant": name, "ptxas": usage,
                       **time_cases(cs, fk, data, check=name == "full")}
                results[name] = rec
                print(json.dumps(rec), flush=True)
            kbuild.BUILD.libs["flash"] = libs["full"][0]
            fk._RESIDENT.clear()
            waves, fk.FLASH_SPLIT_WAVES = fk.FLASH_SPLIT_WAVES, 0
            rec = {"variant": "no_split", **time_cases(cs, fk, data,
                                                       check=True)}
            fk.FLASH_SPLIT_WAVES = waves
            results["no_split"] = rec
            print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"device": smi, "cases": CASES, "variants": results}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
