"""One module a per-layer metric, found by the metric's name in
BENCHMARK.json: ``LAYER`` (the layer as PERF.md lists it), ``MOVES`` (the
end-to-end metric it should move) and ``read(ctx)``, which returns the
number, or None where the run holds nothing to read (the metric is then
left out of the result).

``ctx`` (perfbench/cell.Context): cfg (the configuration file), views,
batch; over the measured window: step_s (host seconds of each step() call),
stages ({span: [device ms]} of the program's stage timer), frames,
window_s; over the traced frames after it: kernels [(name, start_us,
end_us)], trace_frames, trace_s, busy_s."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
