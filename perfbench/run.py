"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. NAME is a cell of BENCHMARK.json; its
configuration, traffic and limits are the files that BENCHMARK.json and
perfbench/cells/NAME.json name. --trace 0 prints the cell's end-to-end
metrics, --trace 1 its per-layer metrics, the device's busy and traced
seconds and the breakdown of the trace. The last line of standard output
is one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the numbers compared with the reference,
each beside its limit); the same numbers are the last lines of standard
error.

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, when the program cannot be imported, and
when the process has loaded jax, jaxlib, flax or the JAX package
(``toc3d_tpu``; module names compared whole) by the window's close.
Kernel and compiler caches stay in the checkout's build/ directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "toc3d_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _caches():
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    from .cell import process_start, run_cell
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", ROOT,
                              t_start=process_start())
    result.pop("_judged", None)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    print(f"frames in the window {result['attempted']}, failed "
          f"{result['failed']}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _power_limit():
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
