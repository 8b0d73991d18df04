"""Readings of the control and of the planted faults, at a cell's size.

    python3 shedbench/control.py --workload <name> --seeds 1,2,3 --seconds 4

For each seed and each variant, one run of the cell with a stand-in in
the program's place (``shedharness.standin``), a window of ``--seconds``
and a checked step every other step; prints one JSON line a run with the
numbers its check compared. Variants: ``bf16`` (the reference in
bfloat16, the precision below the configuration's float32), ``stale``,
``half`` and ``flip`` (faults planted in the float32 reference),
``flip_program`` (``flip`` planted in the program) and ``flip_sent`` (one
frame of every ``next_frames`` of the program altered). The benchmark's own
runs never run this; it sets the upper readings of the limits.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--variants", help="comma-separated (default: all)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from shedharness.cell import run_cell
    from shedharness.spec import load_cell
    from shedharness.standin import VARIANTS, make_variant

    spec = load_cell(ROOT, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for variant in (args.variants.split(",") if args.variants
                        else VARIANTS):
            t0 = time.perf_counter()
            out, _ = run_cell(spec, seed=seed, seconds=args.seconds,
                              trace=False, device="cuda", t_origin=t0,
                              make_program=make_variant(variant),
                              sample_gap=2)
            print(json.dumps({"workload": spec.name, "seed": seed,
                              "variant": variant, "correct": out["correct"],
                              "frames": out["attempted"],
                              "seconds": time.perf_counter() - t0,
                              "check": {k: v["value"] for k, v in
                                        out["check"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
