"""Readings that the comparison's limits are set from: one process runs a
cell on many seeds, with the program as the configuration states it, with
--control the program's own int8 path in its place (the encoder's and the
decoder's, dynamic scales; perfbench/program.program_config), or with --fault NAME a fault of perfbench/faults.py
planted under the timed path, and prints every compared frame's numbers
and each seed's largest.

    python3 -m perfbench.calibrate --workload NAME --seconds S
        [--control | --fault NAME] SEED [SEED ...]

The benchmark's own runs never run this tool.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import run as run_mod
from .faults import FAULTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    run_mod._caches()
    from .cell import run_cell
    bench = json.loads((run_mod.ROOT / "BENCHMARK.json").read_text())
    label = "control " if args.control else \
        f"fault {args.fault} " if args.fault else ""
    worst = {}
    for seed in args.seeds:
        result, checks = run_cell(
            bench, args.workload, seed, args.seconds, False, args.device,
            run_mod.ROOT, control=args.control,
            wrap_entry=FAULTS[args.fault] if args.fault else None)
        for i, kind, nums in result["_judged"]:
            print(f"seed {seed} frame {i} ({kind}): " + ", ".join(
                f"{k} {v!r}" for k, v in nums.items()), flush=True)
        line = {}
        for _, _, nums in result["_judged"]:
            for n, v in nums.items():
                line[n] = max(line.get(n, 0.0), v)
        print(f"{label}seed {seed}: " + json.dumps(line) + f" frames "
              f"{result['attempted']} failed {result['failed']} "
              f"correct {result['correct']}", flush=True)
        for n, v in line.items():
            worst[n] = max(worst.get(n, 0.0), v)
    print("largest " + label + json.dumps(worst), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
