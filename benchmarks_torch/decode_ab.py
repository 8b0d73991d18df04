#!/usr/bin/env python3
"""Greedy decode ms a token of two source trees, alternated on one card.

    python3 benchmarks_torch/decode_ab.py --src A/ B/ [--order ABBAAB]
        [--archs xlstm-125m:1,8 granite-moe-1b-a400m:1] [--out FILE]

Each ``--src`` is a checkout's root (its ``chip_smoke.py`` and ``src/``,
e.g. a parent commit unpacked by ``git archive`` into a gitignored
directory). For each letter of ``--order`` a fresh process of that tree
draws each arch's seeded full-width weights on the card
(``chip_smoke._draw``) and times ``--repeats`` runs of
``chip_smoke.timed_decode`` (bf16, a prompt of ``--prefill`` tokens,
``--steps`` greedy steps, the median ms a token) at each batch size.
Prints one JSON object (the card, each run's tree and medians); decode
is host-bound, so compare trees only within one call.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys
root, archs, prefill, steps, repeats = sys.argv[1:6]
sys.path.insert(0, root)
sys.path.insert(0, root + "/src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
dev = torch.device("cuda")
res = {}
for item in archs.split():
    arch, batches = item.split(":")
    cfg = get_config(arch)
    params, _, _ = cs._draw(cfg, dev, 13)
    for B in map(int, batches.split(",")):
        res[f"{arch}_B{B}"] = [
            cs.timed_decode(cfg, params, B, int(prefill), int(prefill) + int(steps),
                            int(steps))["ms_per_token"] for _ in range(int(repeats))]
    del params
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(res), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBAAB")
    ap.add_argument("--archs", nargs="+",
                    default=["xlstm-125m:1,8", "granite-moe-1b-a400m:1"])
    ap.add_argument("--prefill", type=int, default=128)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    runs = []
    for letter in args.order:
        root = str(Path(args.src["AB".index(letter)]).resolve())
        p = subprocess.run([sys.executable, "-c", RUN, root, " ".join(args.archs),
                            str(args.prefill), str(args.steps), str(args.repeats)],
                           capture_output=True, text=True)
        got = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode or not got:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append({"tree": letter, "src": root,
                     **json.loads(got[-1][len("RESULT "):])})
        print(json.dumps(runs[-1]), flush=True)
    res = {"card": card, "order": args.order, "runs": runs}
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
