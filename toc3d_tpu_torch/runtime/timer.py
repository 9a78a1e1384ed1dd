"""Per-stage timing of the streaming frame (counterpart of
toc3d_tpu/runtime/timer.py :: GlobalTimer, :21, whose spans nest as 'A/B').

GlobalTimer synchronises the device around every span. Here a span writes
a begin and an end stamp into a log on the device instead (ops/cuda/stamp:
one thread reads the card's global timer on the current stream), so timing
leaves the frame's queue as it is, every span of the card shares one clock,
and the log is read only by ``samples``. A span opened while a CUDA graph
captures becomes two stamp nodes of the graph, which append a fresh pair on
every replay with no host read. On the CPU the same log takes the host
clock.

Spans nest. While a span of a timer is open, that timer is the current one
(process-local), and ``stage(name)`` opens the child ``parent/name`` of its
innermost open span, so the model marks its stages without a timer handed
down to it: the captured frame's runner (runtime/capture.py) opens
"backbone+neck" and "head+decode" around each program's first eager run
and its capture, and the
stages inside ("select" a token selector, "decoder") are captured with
them. With no timer current, and under torch.export, ``stage`` does
nothing, so a program captured without a timer holds no stamp. Every span
also opens ``torch.profiler.record_function("toc3d.<path>")``: a profiler
trace shows the stages as host ranges beside the stamp kernels.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

from ..ops.cuda import exporting
from ..ops.cuda.stamp import stamp

# 4 MiB of 16-byte entries: over 11000 V2-99 frames at 22 stamps a frame
# (85 s at 130 frames/s), over 18000 ToC3D frames at 14
LOG_ENTRIES = 1 << 18

_current = None


def current():
    """The timer whose span is open, or None."""
    return _current


class StageTimer:
    """Named, nested spans, each sample a time in ms; ``reset`` drops the
    samples taken so far (the warm-up's). ``capacity``: the stamps the log
    holds between two reads (two a span); ``samples`` raises once more
    were taken. On the card the stamp kernel is built and loaded here."""

    def __init__(self, device, capacity: int = LOG_ENTRIES):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            from ..ops.cuda.build import load
            load("stamp")
        self._log = torch.zeros(capacity, 2, dtype=torch.int64,
                                device=device)
        self._count = torch.zeros(1, dtype=torch.int32, device=device)
        self._paths = []        # span id -> path
        self._ids = {}          # path -> span id
        self._open = []         # paths of the open spans, innermost last
        self.reset()

    def reset(self):
        self._count.zero_()
        self._spans = []        # (path, begin ns, end ns), decoded

    @contextmanager
    def span(self, name: str):
        global _current
        path = f"{self._open[-1]}/{name}" if self._open else name
        i = self._ids.get(path)
        if i is None:
            i = self._ids[path] = len(self._paths)
            self._paths.append(path)
        outer, _current = _current, self
        self._open.append(path)
        try:
            with torch.profiler.record_function(f"toc3d.{path}"):
                stamp(self._log, self._count, 2 * i)
                yield
                stamp(self._log, self._count, 2 * i + 1)
        finally:
            self._open.pop()
            _current = outer

    def spans(self) -> list:
        """[(path, begin ns, end ns)] of every span closed since
        ``reset``, on one clock, in the order they closed. Copies the log
        once (waiting for the device), decodes and empties it; raises if
        it filled."""
        if self.cuda:
            torch.cuda.synchronize(self._log.device)
        n, cap = int(self._count.item()), self._log.shape[0]
        if n > cap:
            raise RuntimeError(
                f"StageTimer: the stamp log of {cap} entries filled and "
                f"dropped {n - cap} stamps; read it more often or give a "
                "larger capacity")
        begun = {}
        for word, ns in self._log[:n].tolist():
            i, end = divmod(word, 2)
            if not end:
                begun[i] = ns
            elif i in begun:
                self._spans.append((self._paths[i], begun.pop(i), ns))
        self._count.zero_()
        return list(self._spans)

    def samples(self) -> dict:
        """{path: [ms of each span, in order]} (``spans``)."""
        out = defaultdict(list)
        for path, t0, t1 in self.spans():
            out[path].append((t1 - t0) * 1e-6)
        return dict(out)

    def summary(self) -> dict:
        """{path: {"mean", "min", "max", "n"}} in ms (``samples``)."""
        return {name: {"mean": sum(xs) / len(xs), "min": min(xs),
                       "max": max(xs), "n": len(xs)}
                for name, xs in self.samples().items()}


def span(timer, name: str):
    """``timer.span(name)``, or nothing when timer is None."""
    return nullcontext() if timer is None else timer.span(name)


def stage(name: str):
    """The child ``name`` of the current timer's innermost open span;
    nothing with no timer current or while torch.export traces."""
    if _current is None or exporting():
        return nullcontext()
    return _current.span(name)


def tree(samples: dict) -> list:
    """Lines of {path: [ms]} as GlobalTimer.log prints them: an indented
    'A/B' tree, each span's mean, min, max and count."""
    lines = []
    for name in sorted(samples):
        xs = samples[name]
        lines.append(f"{'  ' * name.count('/')}{name.split('/')[-1]}: mean "
                     f"{sum(xs) / len(xs):.3f} ms  min {min(xs):.3f}  max "
                     f"{max(xs):.3f}  (n={len(xs)})")
    return lines
