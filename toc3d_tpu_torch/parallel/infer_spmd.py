"""View-sharded streaming inference over process groups (counterpart of
toc3d_tpu/parallel/infer_spmd.py).

The backbone and the neck never mix views (the selector broadcasts the
lane's motion queries over however many views it sees), so the ranks of a
'view' group each run ``extract_img_feat`` on their slice of the frame's
views, the neck features are all-gathered over the group, and every rank
runs the small head (``head_step``) on the whole frame, keeping the memory
bank replicated with no further traffic. On a ('data', 'view') product
mesh the lanes are split too: the ranks of a 'view' group share one block
of lanes, and the head runs on those lanes only. The two mesh axes become
two families of subgroups (``dist.new_group``): a 'view' group for each
block of lanes, a 'data' group for each slice of views.

Same two programs as ``make_infer_fn``: on a CUDA model the captured
frame of runtime/graphs.CapturedInfer, with the all-gather between the
two captured programs, outside the graphs; on the CPU ``extract_img_feat``
and ``head_step`` eagerly. The gather runs in every world, one rank
included. Deterministic eval only: eval_mask 'gumbel' raises, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import DetectorState, is_steady
from ..models.detector import (extract_img_feat, frame_to_device, head_step,
                               precast_backbone_)
from ..ops.cuda import param_key
from ..runtime.graphs import CapturedInfer
from ..runtime.timer import span


def _view_fit(num_views: int, limit: int) -> int:
    return max(d for d in range(1, num_views + 1)
               if num_views % d == 0 and d <= limit)


def mesh_shape(num_views: int, limit: int,
               n_data: Optional[int] = None) -> Tuple[int, int]:
    """(data, view) sizes of a mesh over ``limit`` ranks, by JAX's rules:
    'view' the largest divisor of num_views that fits (6 views -> 6, 3, 2
    or 1), 'data' n_data replicas of that column, or as many as the rest
    of the ranks allow (view_mesh: n_data 1)."""
    if n_data is None:
        k = _view_fit(num_views, limit)
        return limit // k, k
    if not 1 <= n_data <= limit:
        raise ValueError(f"n_data={n_data} data shards do not fit the "
                         f"{limit} available rank(s)")
    return n_data, _view_fit(num_views, limit // n_data)


@dataclass
class ProcessMesh:
    """A ('data', 'view') grid of global ranks, row-major: rank
    ``i * view + j`` holds lane block i and view slice j. ``member`` is
    False on a rank outside the grid (it runs nothing); ``view_group`` is
    this rank's 'view' subgroup (the ranks of its lane block, over which
    the features are gathered), ``data_group`` its 'data' subgroup (the
    ranks of its view slice)."""
    data: int
    view: int
    member: bool
    data_index: int
    view_index: int
    view_group: object
    data_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "view": self.view}


def _make_mesh(d: int, k: int) -> ProcessMesh:
    """Create both families of subgroups over the first d * k ranks. Every
    rank of the world calls this, in the same order (dist.new_group)."""
    me = dist.get_rank()
    if d * k > dist.get_world_size():
        raise ValueError(f"a {d} x {k} mesh needs {d * k} ranks, the world "
                         f"has {dist.get_world_size()}")
    view_group = data_group = None
    for i in range(d):
        g = dist.new_group([i * k + j for j in range(k)])
        if i == me // k:
            view_group = g
    for j in range(k):
        g = dist.new_group([i * k + j for i in range(d)])
        if j == me % k:
            data_group = g
    member = me < d * k
    return ProcessMesh(d, k, member, me // k if member else -1,
                       me % k if member else -1,
                       view_group if member else None,
                       data_group if member else None)


def view_mesh(num_views: int = 6, n_devices: Optional[int] = None
              ) -> ProcessMesh:
    """A 1-D 'view' mesh over the largest divisor of num_views that fits
    the world (or n_devices of it); the lanes are not split."""
    limit = dist.get_world_size() if n_devices is None \
        else min(n_devices, dist.get_world_size())
    return _make_mesh(1, _view_fit(num_views, limit))


def product_mesh(num_views: int = 6, n_data: Optional[int] = None,
                 n_devices: Optional[int] = None) -> ProcessMesh:
    """A ('data', 'view') mesh (mesh_shape's rules): with 8 ranks and 6
    views (1, 6) by default, n_data=2 -> (2, 3), n_data=4 -> (4, 2)."""
    limit = dist.get_world_size() if n_devices is None \
        else min(n_devices, dist.get_world_size())
    return _make_mesh(*mesh_shape(num_views, limit, n_data))


def _local(frame, mesh: ProcessMesh):
    """This rank's part of a global frame: its lanes of every field, its
    views of the images; numpy stays numpy, tensors stay where they lie
    (each part contiguous)."""
    b, n = frame["img"].shape[:2]
    if b % mesh.data or n % mesh.view:
        raise ValueError(f"a frame of {b} lanes x {n} views does not split "
                         f"over a {mesh.data} x {mesh.view} mesh")
    lb, lv = b // mesh.data, n // mesh.view
    lanes = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)
    views = slice(mesh.view_index * lv, (mesh.view_index + 1) * lv)
    cont = lambda x: x.contiguous() if isinstance(x, torch.Tensor) \
        else np.ascontiguousarray(x)
    out = {k: cont(v[lanes]) for k, v in frame.items() if k != "img"}
    out["img"] = cont(frame["img"][lanes, views])
    return out


def gather_views(local: torch.Tensor, out: torch.Tensor, mesh: ProcessMesh,
                 parts=None) -> torch.Tensor:
    """All-gather the view group's features (B, n_local, h, w, C) into
    ``out`` (B, n_local * view, h, w, C), slices in rank order. ``parts``:
    (view, B, n_local, h, w, C) scratch the gather writes (allocated when
    None)."""
    if parts is None:
        parts = local.new_empty((mesh.view,) + tuple(local.shape))
    dist.all_gather(list(parts.unbind(0)), local, group=mesh.view_group)
    b, nl = local.shape[:2]
    out.view((b, mesh.view, nl) + tuple(local.shape[2:])).copy_(
        parts.transpose(0, 1))
    return out


class ShardedCapturedInfer(CapturedInfer):
    """CapturedInfer with the backbone on this rank's views: the backbone
    program writes its slice of the features, and the exchange step
    all-gathers the slices over the view group into the static buffer the
    head program reads, between the two replays and outside the graphs."""

    def __init__(self, model, mesh: ProcessMesh, timer=None):
        self.mesh = mesh
        self._gather = None
        super().__init__(model, timer)

    def _exchange(self, local):
        """The gather's scratch and output are static buffers, laid out
        anew with the runner's features buffer ``local``."""
        if self._gather is None or self._gather[0] is not local:
            b, nl = local.shape[:2]
            self._gather = (local, local.new_empty((self.mesh.view,)
                                                   + tuple(local.shape)),
                            local.new_empty((b, nl * self.mesh.view)
                                            + tuple(local.shape[2:])))
        _, parts, out = self._gather
        with span(self.timer, "all-gather"):
            return gather_views(local, out, self.mesh, parts)

    def __call__(self, state: DetectorState, frame):
        return super().__call__(state, _local(frame, self.mesh))


def make_spmd_infer_fn(model, mesh: ProcessMesh, timer=None):
    """``infer(state, frame) -> (state', DecodedBoxes)`` with the backbone
    view-sharded over ``mesh``'s 'view' groups and the head replicated in
    each, or, on a product mesh, run on the rank's lanes. ``frame``: the
    global frame (every lane and view; numpy or tensors, on the host or
    the card); ``state``: this rank's lanes' (all of them on a 1-D view
    mesh); the result is this rank's lanes'. Every rank of a mesh calls it
    for every frame (the gather is collective). The weights are cast (or
    quantized) once per weight key, as make_infer_fn does
    (precast_backbone_). Raises for eval_mask 'gumbel' and on a rank
    outside the mesh."""
    cfg = model.cfg
    if getattr(cfg.backbone, "eval_mask", "softmax") == "gumbel":
        raise ValueError("the stochastic eval mask is single-process only; "
                         "use make_infer_fn")
    if not mesh.member:
        raise ValueError(f"rank {dist.get_rank()} is outside the "
                         f"{mesh.data} x {mesh.view} mesh")
    if next(model.parameters()).is_cuda:
        return ShardedCapturedInfer(model, mesh, timer)
    key = [None]

    @torch.no_grad()
    def infer(state: DetectorState, frame):
        if param_key(model) != key[0]:
            precast_backbone_(model)
            key[0] = param_key(model)
        frame = frame_to_device(_local(frame, mesh), "cpu")
        local = extract_img_feat(model, frame["img"], state.memory, frame,
                                 steady=is_steady(frame))
        b, nl = local.shape[:2]
        feats = local.new_empty((b, nl * mesh.view) + tuple(local.shape[2:]))
        gather_views(local, feats, mesh)
        return head_step(model, state, feats, frame)
    return infer
