"""The streaming frame as captured CUDA graphs (counterpart of
toc3d_tpu/models/detector.py :: make_infer_fn, :369-406, which jit-compiles
the frame as two programs).

Run eagerly, a frame pays the host for every launch: about two thousand
kernels, each behind Python checks and a ctypes call, so the card idles
for most of it. Captured, the host replays three graphs through the
streamed-frame runner (runtime/capture.FrameRunner):

* backbone + neck (``extract_img_feat``); for the ToC3D backbone, one
  graph per value of ``steady``. JAX picks the first-frame selector branch
  on the device (``lax.cond``, token_select.py:227); here the host reads it
  from the frame's ``prev_exists`` (``is_steady``: no device read when the
  frame lies on the host) and replays the matching graph. The plain
  backbone has no such branch and one graph;
* head + decode (``head_step``), one graph.

Under eval_mask 'gumbel' each call also draws the frame's selector noise
into static buffers, from the explicit generator of ``detector.MaskNoise``
and outside the graphs, so every replay sees fresh noise, the noise eager
``infer_step`` sees from the same ``mask_seed``.

The graphs read the weight packs that ``precast_backbone_`` and
``cached_pack`` built, at the addresses they had at capture. Every call
therefore compares the model's weight key (``ops.cuda.param_key``: each
parameter's and buffer's storage and version) with the one the graphs were
captured under; a ``load_state_dict``, ``attach_act_scales``,
``runtime/checkpoint.load_backbone_pretrained`` or in-place update changes
it, and the programs are packed and captured again. So does
a frame or bank of another layout. A capture or replay that fails raises;
nothing falls back to eager execution. Launch counters tick on every
replay.
"""
from __future__ import annotations

import torch

from ..core.state import DetectorState, is_steady
from ..models.detector import (MaskNoise, extract_img_feat, frame_tensors,
                               head_step, precast_backbone_)
from ..ops.cuda import param_key
from .capture import FrameRunner


class CapturedInfer:
    """``infer(state, frame) -> (state', DecodedBoxes)`` on a CUDA model,
    as replayed CUDA graphs (see the module note). ``timer``: a
    runtime.timer.StageTimer for the spans "inputs", "backbone+neck" and
    "head+decode" (runtime/capture.FrameRunner), so the stages inside
    ("backbone+neck/select", "head+decode/decoder") are captured as stamp
    nodes; without a timer the graphs hold none. ``mask_seed``: the seed of
    the eval_mask 'gumbel' noise (MaskNoise)."""

    def __init__(self, model, timer=None, mask_seed: int = 0):
        self.model = model
        self.timer = timer
        self.noise = MaskNoise(model, mask_seed)
        self.device = next(model.parameters()).device
        self.runner = FrameRunner(self.device, self._noise_buffers)
        self._reset()

    def _reset(self):
        """Pack the weights and take their key; the next call lays out its
        buffers and captures anew."""
        precast_backbone_(self.model)
        self._key = param_key(self.model)
        self.runner.drop()

    def _noise_buffers(self, frame):
        return [torch.empty(self.noise.shape(frame["img"].shape),
                            dtype=torch.float32, device=self.device)
                for _ in range(self.noise.selectors)] or None

    def _backbone(self, steady):
        return lambda frame, bank: extract_img_feat(
            self.model, frame["img"], bank, frame, steady=steady,
            mask_noise=self.runner.extra)

    def _head(self, bank, feats, frame):
        state, det = head_step(self.model, DetectorState(bank), feats, frame)
        return state.memory, det

    def _exchange(self, feats):
        """Between the two programs, outside the graphs: nothing here; the
        view-sharded frame gathers the ranks' features
        (parallel/infer_spmd.ShardedCapturedInfer)."""
        return feats

    @torch.no_grad()
    def __call__(self, state: DetectorState, frame):
        steady = is_steady(frame)
        if param_key(self.model) != self._key:
            self._reset()
        frame = frame_tensors(frame)
        key = ("backbone+neck", steady) if self.model.cfg.is_toc3d \
            else ("backbone+neck",)
        return self.runner(
            frame, state.memory, key, self._backbone(steady), self._head,
            exchange=self._exchange, timer=self.timer,
            fill=lambda: self.noise.draw(frame["img"].shape,
                                         out=self.runner.extra))
