"""One module an end-to-end metric, found by its name in BENCHMARK.json:
``read(run)`` -> the number, from the benchmark's own host clock and the
allocator's peak (perfbench/cell.Run), or None where the run has none."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
