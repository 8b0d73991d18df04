"""Run one cell of the shed-step benchmark once.

    python3 shedbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell comes from ``BENCHMARK.json``; its
inputs are made from ``--seed``; the program is ``repro_torch`` (from
``src/``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``check``, each
number compared beside its limit (also the last lines of standard error).
The run needs the CUDA cards the cell asks for and exits non-zero
without printing a result when they are missing, when the program is
missing, or when JAX or the JAX package is loaded after the window.
"""
import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is another name)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    import torch

    from shedharness.cell import run_cell
    from shedharness.spec import load_cell

    spec = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    out, lines = run_cell(spec, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_origin=T_ORIGIN)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 4
    if args.trace:
        out["device"]["power"] = card_power()
    for ln in lines:
        print(ln, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
