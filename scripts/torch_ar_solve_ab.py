#!/usr/bin/env python3
"""The ar_solve phases of `chip_smoke.py` in several checkouts, in turns,
on one CUDA card: the way to compare two versions of the port's Hopper
ar_solve kernels within one run.

    python3 scripts/torch_ar_solve_ab.py --trees OLD NEW NEW OLD --out results.jsonl \
        [--bwd-time-rows-64 128 256 7680]

Each tree runs in its own process, which imports that tree's own
`chip_smoke.py` and `mmvae_tpu_torch` (an unpacked `git archive` of another
commit, or the repo itself), builds its kernels and runs every phase of its
smoke whose name starts with `phase_ar_solve` (checks, times and bounds),
TF32 off. Each JSON line those phases print is passed on with the tree and
the card's name and power limit beside it, and written to `--out` too.
`--bwd-time-rows-64` sets the rows at which each tree's
`phase_ar_solve_latent64` times the backward (`LATENT64_BWD_TIME_ROWS`), so
that trees which time different rows are timed at the same ones.
Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def run_phases(tree, bwd_time_rows_64=None):
    """In this process: `tree`'s chip_smoke, its build and ar_solve phases."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if bwd_time_rows_64:
        chip_smoke.LATENT64_BWD_TIME_ROWS = tuple(bwd_time_rows_64)
    chip_smoke.phase_build()
    for name in sorted(n for n in dir(chip_smoke) if n.startswith("phase_ar_solve")):
        chip_smoke.emit({"phase": "ab_phase", "name": name})
        getattr(chip_smoke, name)()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", required=True, help="JSON lines file for every result")
    ap.add_argument("--bwd-time-rows-64", nargs="+", type=int,
                    help="rows at which D = 64's backward is timed in every tree")
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ar_solve_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.run:
        run_phases(args.trees[0], args.bwd_time_rows_64)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    with open(args.out, "a") as out:
        for turn, tree in enumerate(args.trees):
            extra = (["--bwd-time-rows-64", *map(str, args.bwd_time_rows_64)]
                     if args.bwd_time_rows_64 else [])
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                                   "--trees", os.path.abspath(tree), "--out", args.out, *extra],
                                  capture_output=True, text=True, timeout=1800,
                                  cwd=os.path.abspath(tree))
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    row = json.dumps({"tree": tree, "turn": turn, "card": card,
                                      **json.loads(line)})
                    print(row, flush=True)
                    out.write(row + "\n")
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
