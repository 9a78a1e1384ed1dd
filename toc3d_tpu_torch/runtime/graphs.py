"""The streaming frame as captured CUDA graphs (counterpart of
toc3d_tpu/models/detector.py :: make_infer_fn, :369-406, which jit-compiles
the frame as two programs).

Run eagerly, a frame pays the host for every launch: about two thousand
kernels, each behind Python checks and a ctypes call, so the card idles
for most of it. Captured, the host replays three graphs:

* backbone + neck (``extract_img_feat``); for the ToC3D backbone, one
  graph per value of ``steady``. JAX picks the first-frame selector branch
  on the device (``lax.cond``, token_select.py:227); here the host reads it
  from the frame's ``prev_exists`` (``is_steady``: no device read when the
  frame lies on the host) and replays the matching graph. The plain
  backbone has no such branch and one graph. Each writes the neck features
  into one buffer allocated outside the graphs;
* head + decode (``head_step``), one graph.

Each call copies the frame and the memory bank into static input buffers
(a host frame in pinned memory is copied without blocking the host); under
eval_mask 'gumbel' it also draws the frame's selector noise into static
buffers, from the explicit generator of ``detector.MaskNoise`` and outside
the graphs, so every replay sees fresh noise, the noise eager
``infer_step`` sees from the same ``mask_seed``. It then replays
the two programs and returns the state and boxes as fresh tensors, copied
out of the graph's outputs, so results a caller holds are never overwritten
by a later replay.

A program's first use runs eagerly on a side stream and is that frame's
result, then the program is captured on the same stream
(runtime/capture.py). The three graphs share one memory pool: they never
run at once, and their outputs stay referenced, so no live tensor is
reused.

The graphs read the weight packs that ``precast_backbone_`` and
``cached_pack`` built, at the addresses they had at capture. Every call
therefore compares the model's weight key (``ops.cuda.param_key``: each
parameter's and buffer's storage and version) with the one the graphs were
captured under; a ``load_state_dict``, ``attach_act_scales``,
``runtime/checkpoint.load_backbone_pretrained`` or in-place update changes
it, and the programs are packed and captured again. So does
a frame or bank of other shapes. A capture or replay that fails raises;
nothing falls back to eager execution. Launch counters tick on every
replay.
"""
from __future__ import annotations

import torch

from ..models.detector import (DetectorState, MaskNoise, extract_img_feat,
                               frame_tensors, head_step, is_steady,
                               precast_backbone_)
from ..models.streampetr_head import MemoryBank
from ..ops.cuda import param_key
from .capture import run_captured
from .timer import span


class CapturedInfer:
    """``infer(state, frame) -> (state', DecodedBoxes)`` on a CUDA model,
    as replayed CUDA graphs (see the module note). ``timer``: a
    runtime.timer.StageTimer for the spans "inputs", "backbone+neck" and
    "head+decode", opened around each program's first eager run and its
    capture too, so the stages inside ("backbone+neck/select",
    "head+decode/decoder") are captured as stamp nodes; without a timer the
    graphs hold none. ``mask_seed``: the seed of the eval_mask 'gumbel'
    noise (MaskNoise)."""

    def __init__(self, model, timer=None, mask_seed: int = 0):
        self.model = model
        self.timer = timer
        self.noise = MaskNoise(model, mask_seed)
        self.device = next(model.parameters()).device
        self.stream = torch.cuda.Stream(self.device)
        self._reset()

    def _reset(self):
        """Pack the weights and take their key; the next call allocates
        its buffers and captures anew."""
        precast_backbone_(self.model)
        self._key = param_key(self.model)
        self._shapes = None

    def _buffers(self, frame, bank):
        """Static input buffers for this frame and bank: the frame's laid
        out as its tensors (shape, strides, dtype), so each copy into them
        is one plain copy, from pinned memory where the frame is pinned (a
        host tensor of other strides would first be made contiguous in
        pageable memory); the bank's contiguous. A change of layout drops
        the graphs captured on the old buffers."""
        shapes = tuple((k, tuple(t.shape), t.stride(), t.dtype)
                       for k, t in frame.items()) + tuple(
            (tuple(t.shape), t.dtype) for t in bank)
        if shapes == self._shapes:
            return
        self._programs = {}
        self._pool = torch.cuda.graph_pool_handle()
        self._shapes = shapes
        dev = self.device
        self._frame = {k: torch.empty_strided(t.shape, t.stride(),
                                              dtype=t.dtype, device=dev)
                       for k, t in frame.items()}
        self._bank = MemoryBank(*(torch.empty(t.shape, dtype=t.dtype,
                                              device=dev) for t in bank))
        self._noise = [torch.empty(self.noise.shape(frame["img"].shape),
                                   dtype=torch.float32, device=dev)
                       for _ in range(self.noise.selectors)] or None
        self._feats = None

    def _run(self, name, fn):
        """Replay program ``name``; at its first use run ``fn`` eagerly (the
        frame's result) and capture it (runtime/capture.py)."""
        return run_captured(self._programs, name, fn, self.stream,
                            self._pool, self.device)

    def _backbone(self, steady):
        def fn():
            f = self._frame
            feats = extract_img_feat(self.model, f["img"], self._bank, f,
                                     steady=steady, mask_noise=self._noise)
            if self._feats is None:     # first eager run: the static output
                self._feats = torch.empty_like(feats)
            return self._feats.copy_(feats)
        return fn

    def _exchange(self):
        """Between the two programs, outside the graphs: nothing here; the
        view-sharded frame gathers the ranks' features
        (parallel/infer_spmd.ShardedCapturedInfer)."""

    def _head(self):
        return head_step(self.model, DetectorState(self._bank), self._feats,
                         self._frame)

    @torch.no_grad()
    def __call__(self, state: DetectorState, frame):
        steady = is_steady(frame)
        if param_key(self.model) != self._key:
            self._reset()
        frame = frame_tensors(frame)
        self._buffers(frame, state.memory)
        with span(self.timer, "inputs"):
            for k, t in frame.items():
                self._frame[k].copy_(t, non_blocking=True)
            for buf, t in zip(self._bank, state.memory):
                buf.copy_(t, non_blocking=True)
            self.noise.draw(frame["img"].shape, out=self._noise)
        key = ("backbone+neck", steady) if self.model.cfg.is_toc3d \
            else ("backbone+neck",)
        with span(self.timer, "backbone+neck"):
            self._run(key, self._backbone(steady))
        self._exchange()
        with span(self.timer, "head+decode"):
            new_state, det = self._run("head+decode", self._head)
            return (DetectorState(MemoryBank(*(t.clone()
                                               for t in new_state.memory))),
                    type(det)(*(t.clone() for t in det)))
