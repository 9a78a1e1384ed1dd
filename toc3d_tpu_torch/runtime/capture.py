"""The streamed frame as two captured CUDA graph programs, backbone (+ neck)
and head (+ decode): the one runner behind the captured frame
(runtime/graphs.CapturedInfer), the served export
(runtime/export.ExportedDetector) and the view-sharded frame
(parallel/infer_spmd.ShardedCapturedInfer); each front end gives the
programs' functions. It imports no model module, so a loaded artifact
captures its programs without the model code.

A program's first use runs eagerly on a side stream and is that call's
result; it also does what a capture cannot: the kernels' shared-memory
attributes and tensor maps, cached constants and weight packs, the
libraries' handles and workspaces. The program is then captured on the same
stream into the runner's memory pool. A capture that fails raises; nothing
carries on eagerly.

Launch counters: a replay runs no Python wrapper, so each capture records
every counter's change (the capture itself launches nothing, and the
counters are put back) and each replay adds that change.

Stage spans (runtime/timer.py): a program captured while a stage timer is
current holds that timer's stamp nodes, which write into its log on every
replay; the program keeps the timer, and so its log, alive.
"""
from __future__ import annotations

import torch

from ..core.coder import DecodedBoxes
from ..core.state import DetectorState, MemoryBank
from ..ops.cuda import counted_wrappers
from .timer import current, span


class Program:
    """One captured graph, its output, the launches each replay makes and
    the stage timer whose log its stamps write (or None)."""

    def __init__(self, graph, out, launches, timer):
        self.graph, self.out, self.launches = graph, out, launches
        self.timer = timer

    def replay(self):
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n
        return self.out


class FrameRunner:
    """``runner(frame, bank, key, backbone, head) -> (state', boxes)`` on a
    CUDA ``device``.

    Each call copies ``frame`` ({name: tensor}) and ``bank`` (the memory
    bank's tensors) into static buffers, without blocking the host where
    they lie in pinned memory. The frame's buffers are laid out as its
    tensors (shape, strides, dtype), so each copy is one plain copy (a host
    tensor of other strides would first be made contiguous in pageable
    memory); the bank's are contiguous, so a returned bank of other strides
    is the same layout. A new layout drops every program and buffer and
    captures anew in a new memory pool; so does ``drop()``.

    The backbone program, kept under the caller's ``key``, runs
    ``backbone(frame, bank) -> features`` and writes them into one static
    buffer (allocated at its first eager run); ``exchange(features) ->
    features``, when given, runs between the two programs, outside the
    graphs; the head program "head+decode" runs ``head(bank, features,
    frame) -> (memory, boxes)``. The state and boxes are returned cloned out
    of the graph's outputs, so results a caller holds are never overwritten
    by a later replay. The graphs share one pool: they never run at once,
    and their outputs stay referenced, so no live tensor is reused.

    ``timer``: a runtime.timer.StageTimer for the spans "inputs" (the
    copies, then ``fill()``, the front end's own inputs), "backbone+neck"
    and "head+decode", opened around each program's first eager run and its
    capture too, so the stages inside are captured as stamp nodes.
    ``extra(frame)``: the front end's own static inputs, laid out anew with
    the frame's buffers, in ``extra``."""

    def __init__(self, device, extra=None):
        self.device = device
        self.stream = None
        self._make_extra = extra
        self.drop()

    def drop(self):
        """Drop every program and buffer: the next call lays them out and
        captures anew."""
        self.layout = None
        self.programs = {}
        self.frame = self.bank = self.feats = self.extra = None

    def _lay_out(self, frame, bank):
        layout = tuple((k, tuple(t.shape), t.stride(), t.dtype)
                       for k, t in frame.items()) + tuple(
            (tuple(t.shape), t.dtype) for t in bank)
        if layout == self.layout:
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.drop()
        self.layout = layout
        self.pool = torch.cuda.graph_pool_handle()
        dev = self.device
        self.frame = {k: torch.empty_strided(t.shape, t.stride(),
                                             dtype=t.dtype, device=dev)
                      for k, t in frame.items()}
        self.bank = MemoryBank(*(torch.empty(t.shape, dtype=t.dtype,
                                             device=dev) for t in bank))
        if self._make_extra is not None:
            self.extra = self._make_extra(frame)

    def _run(self, name, fn):
        """Replay ``programs[name]``; at its first use run ``fn`` eagerly on
        the side stream (the call's result), then capture it there."""
        prog = self.programs.get(name)
        if prog is not None:
            return prog.replay()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        counters = list(counted_wrappers().values())
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                captured = fn()
        finally:
            launches = [(f, f.launches - n) for f, n in zip(counters, before)]
            for f, n in zip(counters, before):
                f.launches = n
        self.programs[name] = Program(graph, captured,
                                      [(f, n) for f, n in launches if n],
                                      current())
        return out

    def _features(self, backbone):
        feats = backbone(self.frame, self.bank)
        if self.feats is None:      # first eager run: the static output
            self.feats = torch.empty_like(feats)
        return self.feats.copy_(feats)

    def __call__(self, frame, bank, key, backbone, head, exchange=None,
                 timer=None, fill=None):
        self._lay_out(frame, bank)
        with span(timer, "inputs"):
            for k, t in frame.items():
                self.frame[k].copy_(t, non_blocking=True)
            for buf, t in zip(self.bank, bank):
                buf.copy_(t, non_blocking=True)
            if fill is not None:
                fill()
        with span(timer, "backbone+neck"):
            self._run(key, lambda: self._features(backbone))
        feats = self.feats if exchange is None else exchange(self.feats)
        with span(timer, "head+decode"):
            memory, det = self._run(
                "head+decode", lambda: head(self.bank, feats, self.frame))
            return (DetectorState(MemoryBank(*(t.clone() for t in memory))),
                    DecodedBoxes(*(t.clone() for t in det)))
