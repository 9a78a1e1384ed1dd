"""One module a kernel: ``MATCH`` (a substring of the kernel's name in the
profiler's trace), ``EXCLUDE`` (substrings that rule a name out) and
``launches(cfg, views, batch)``: [(label, operations, bytes)] of the work
one frame asks of that kernel, counted from the configuration
(perfbench/counting.py). ``share`` turns them into the kernel's share of its
roofline."""
from __future__ import annotations

import importlib

from .. import counting, trace


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def bound_seconds(name: str, cfg: dict, views: int, batch: int) -> float:
    """The least time one frame's launches of kernel ``name`` take."""
    return sum(counting.least_time(f, b)
               for _, f, b in load(name).launches(cfg, views, batch))


def share(ctx, name: str):
    """Percent: the frame's least time for kernel ``name`` over its
    measured device time a frame in the traced frames; None where the trace
    holds no launch of it."""
    mod = load(name)
    measured = trace.kernel_seconds(ctx.kernels, mod.MATCH, mod.EXCLUDE)
    if not ctx.kernels or measured <= 0:
        return None
    per_frame = measured / ctx.trace_frames
    return 100.0 * bound_seconds(name, ctx.cfg, ctx.views, ctx.batch) \
        / per_frame
