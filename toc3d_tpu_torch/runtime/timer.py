"""Per-stage timing of the streaming frame (counterpart of
toc3d_tpu/runtime/timer.py :: GlobalTimer, :21).

GlobalTimer synchronises the device around every span. Here a span on the
card records a pair of CUDA events on the current stream instead, so timing
leaves the frame's queue as it is; the events are read only by
``summary``. On the CPU, where the work is synchronous, a span reads the
host clock.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch


class StageTimer:
    """Named spans, each sample a time in ms; ``reset`` drops the samples
    taken so far (the warm-up's)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.reset()

    def reset(self):
        self._pending = []      # (name, start event, end event)
        self._samples = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._pending.append((name, a, b))
        else:
            t0 = time.perf_counter()
            yield
            self._samples[name].append((time.perf_counter() - t0) * 1e3)

    def samples(self) -> dict:
        """{name: [ms of each span, in order]}; waits for the events."""
        for name, a, b in self._pending:
            b.synchronize()
            self._samples[name].append(a.elapsed_time(b))
        self._pending = []
        return {name: list(xs) for name, xs in self._samples.items() if xs}

    def summary(self) -> dict:
        """{name: {"mean", "min", "max", "n"}} in ms; waits for the
        events."""
        return {name: {"mean": sum(xs) / len(xs), "min": min(xs),
                       "max": max(xs), "n": len(xs)}
                for name, xs in self.samples().items()}


def span(timer, name: str):
    """``timer.span(name)``, or nothing when timer is None."""
    return nullcontext() if timer is None else timer.span(name)
