"""Training: loss assembly, optimizer and the train step (counterpart of
toc3d_tpu/runtime/train.py:45-446).

  runner glue  -> reference core/apis/mmdet_train.py
  optimizer    -> AdamW lr 1e-4, backbone lr x0.1, weight decay 0.01, grad
                  clip 35, linear warmup 500 at 1/3, cosine to 1e-3
                  (ToC3D_fast.py:253-271)
  one frame    -> petr3d.py:262-397: the shipped ToC3D configs train with
                  queue_length 1, one frame a step, the memory bank streamed
                  across steps by the batch-lane sampler

bf16 activations (cfg.compute_dtype) over f32 master weights, no loss
scaling (train.py:12-14). The backbone's kernels run as autograd Functions
(ops/trainable.py: the kernel forward, the model path's backward), the
droppath blocks and the decoder layers under torch.utils.checkpoint.

Every random draw of a step comes in one ``TrainNoise``, drawn from an
explicit torch.Generator on the model's device (``draw_train_noise``):
the grid mask, the selectors' gumbel noise, the DN uniform, the
stochastic-depth and the dropout keep masks. A test can therefore hand the
JAX package's own draws across.

Data parallelism (``make_train_step(tx, group=...)``, parallel/mesh.py):
each rank holds its lanes of the global batch and of the memory bank, and
draws the global batch's TrainNoise from the shared seed, keeping its own
lanes (``noise_lanes``), so a world of N at batch b computes what one
process computes at batch N * b. JAX normalizes the losses by counts over
the global batch; here the counts that couple a batch's lanes (each
decoder layer's positives, the DN targets, the 2D positives, the
token-selection elements) go into one vector and one all-reduce a step,
and each rank's loss is W * (its sum) / max(global count, 1). The
gradients are then averaged over the ranks between the backward and the
optimizer (mesh.GradReducer), which equals JAX's pmean; the gradient norm,
the clip and the non-finite skip read the averaged gradients, so every
rank decides alike and the parameters stay equal.

The Hungarian matching (core/assigner.hungarian_match) runs on the
device by default for a CUDA model, the auction kernel once a cost tensor,
so the step reads nothing back; with the 'callback' matcher (the CPU's
default) it reads the device once, every cost of the step in one copy. The
optimizer is branchless: a step whose gradient norm is not finite updates
nothing and counts a skip, decided on the device (skip_on_nonfinite,
train.py:61-101).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.assigner import cost_2d, cost_3d, hungarian_match
from ..core.dn import dn_reference_points, draw_dn_noise, prepare_for_dn
from ..core.losses import token_selection_loss
from ..models.detector import ToC3DDetector, extract_img_feat
from ..models.eva_vit import drop_path_rates
from ..models.focal_head import focal_head_forward
from ..models.focal_head_loss import focal_head_loss, scatter_rows
from ..models.grid_mask import GridDraw, draw_grid, grid_mask
from ..models.petr_transformer import draw_drop_masks, drop_mask_shapes
from ..models.streampetr_head import (MemoryBank, head_forward, init_memory,
                                      location_grid)
from ..models.streampetr_loss import positives, streampetr_loss
from ..models.token_select import gumbel_
from ..ops.consts import const_vector
from .timer import span

FRAME_KEYS = ("intrinsics", "img2lidar", "timestamp", "ego_pose",
              "ego_pose_inv", "prev_exists")


class TrainNoise(NamedTuple):
    """Every draw of one training frame. grid: the GridMask draws (None
    without grid mask); gumbel: per selector (B*N, h*w, 2) f32 (None for
    the plain backbone); dn: (B, scalar, G3, 3) uniform [-1, 1);
    drop_path: {block: (keep (B*N,), keep (B*N,))} of the full blocks with
    stochastic depth; dropout: per decoder layer, the keep masks of its six
    sites (None at dropout 0)."""
    grid: Optional[GridDraw]
    gumbel: Optional[List[torch.Tensor]]
    dn: torch.Tensor
    drop_path: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    dropout: Optional[List[Dict[str, torch.Tensor]]]


def _accelerated(cfg, i: int) -> bool:
    return cfg.is_toc3d and cfg.backbone.block_is_accelerated(i)


def decoder_shapes(cfg, batch_size: int, views: int, gt3=None):
    """(queries, self-attention keys, cross-attention keys) of the training
    decoder: the DN queries (scalar groups of the batch's gt3 padded 3D
    boxes, cfg.head.dn_max_gt by default), the matching and propagated
    ones; the bank appended to the self-attention keys; the FocalHead's
    sample of the memory tokens."""
    hc = cfg.head
    p = hc.scalar * (hc.dn_max_gt if gt3 is None else gt3)
    fh, fw = cfg.pad_shape[0] // cfg.stride, cfg.pad_shape[1] // cfg.stride
    return (p + hc.num_query + hc.num_propagated, p + hc.num_query
            + hc.memory_len, int(views * fh * fw * cfg.focal.train_ratio))


def draw_train_noise(cfg, batch_size: int, views: int,
                     generator: torch.Generator, device,
                     gt3=None) -> TrainNoise:
    """One frame's draws, in this order, from ``generator``: grid mask,
    gumbel per selector, DN uniform, stochastic depth per block, dropout
    per layer. gt3: the batch's padded 3D GT count (cfg.head.dn_max_gt,
    what the loader pads to, by default)."""
    h, w = cfg.pad_shape
    ps = cfg.backbone.patch_size
    bn = batch_size * views
    grid = draw_grid(h, generator, device) if cfg.use_grid_mask else None
    gumbel = None
    if cfg.is_toc3d:
        gumbel = [gumbel_(torch.empty(bn, (h // ps) * (w // ps), 2,
                                      device=device), generator)
                  for _ in cfg.backbone.pruning_loc]
    dn = draw_dn_noise(cfg.head, batch_size, generator, device, gt3)
    dp = {}
    for i, r in enumerate(drop_path_rates(cfg.backbone)):
        if r > 0 and not _accelerated(cfg, i):
            dp[i] = tuple(torch.rand(bn, generator=generator, device=device)
                          < 1.0 - r for _ in range(2))
    nq, nks, nkc = decoder_shapes(cfg, batch_size, views, gt3)
    dropout = draw_drop_masks(
        cfg.head.decoder,
        drop_mask_shapes(cfg.head.decoder, batch_size, nq, nks, nkc),
        generator, device)
    return TrainNoise(grid, gumbel, dn, dp, dropout)


def noise_lanes(noise: TrainNoise, lanes: slice, views: int) -> TrainNoise:
    """The draws of lanes ``lanes`` of a global batch's TrainNoise (views
    images a lane): a data-parallel rank draws the whole batch's noise
    from the shared seed and keeps its own lanes. The grid mask is one
    draw for the whole batch and is kept as it is."""
    vs = slice(lanes.start * views, lanes.stop * views)
    return TrainNoise(
        noise.grid,
        None if noise.gumbel is None else [g[vs] for g in noise.gumbel],
        noise.dn[lanes],
        {i: tuple(k[vs] for k in keep)
         for i, keep in noise.drop_path.items()},
        None if noise.dropout is None else
        [{k: m[lanes] for k, m in d.items()} for d in noise.dropout])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def make_lr_schedule(base_lr=1e-4, warmup_iters=500, warmup_ratio=1.0 / 3,
                     total_iters=42_000, min_lr_ratio=1e-3):
    """Linear warmup, then cosine annealing (ToC3D_fast.py:265-271), as
    optax's join of linear_schedule and cosine_decay_schedule: count (an
    int or a tensor) -> f32 tensor on count's device."""
    init = base_lr * warmup_ratio
    decay = float(max(total_iters - warmup_iters, 1))

    def sched(count):
        c = torch.as_tensor(count).to(torch.float32)
        if warmup_iters > 0:
            frac = 1 - c.clamp(0, warmup_iters) / warmup_iters
            warm = (init - base_lr) * frac + base_lr
        else:
            warm = torch.full_like(c, init)
        cc = torch.minimum(c - warmup_iters, torch.full_like(c, decay))
        cos = 0.5 * (1 + torch.cos(math.pi * cc / decay))
        cosine = base_lr * ((1 - min_lr_ratio) * cos + min_lr_ratio)
        return torch.where(c < warmup_iters, warm, cosine)
    return sched


def param_labels(names):
    """'backbone' (lr x0.1, paramwise custom_keys img_backbone,
    ToC3D_fast.py:256) or 'rest' for each parameter name."""
    return ["backbone" if n.split(".")[0] == "img_backbone" else "rest"
            for n in names]


def get_vit_lr_decay_rate(name: str, lr_decay_rate: float = 1.0,
                          num_layers: int = 12) -> float:
    """Layer-decay multiplier of one parameter (eva_vit.py:574-591), by its
    dotted name, e.g. 'img_backbone.blocks.17.attn.q_proj.weight'."""
    layer_id = num_layers + 1
    if name.startswith("img_backbone"):
        if "pos_embed" in name or "patch_embed" in name:
            layer_id = 0
        elif ".blocks." in name and ".residual." not in name:
            layer_id = int(name.split(".blocks.")[1].split(".")[0]) + 1
    return lr_decay_rate ** (num_layers + 1 - layer_id)


def layer_decay_mults(names, layer_decay: float, depth: int):
    """Per-parameter layer-wise lr decay multipliers (train.py:107-122)."""
    return [get_vit_lr_decay_rate(n, layer_decay, depth) for n in names]


class AdamW:
    """optax's chain of train.py:125-166 on the model's parameters, in
    place: clip_by_global_norm(clip), then AdamW per group (backbone at
    lr x backbone_lr_mult, each on its schedule; b1 0.9, b2 0.999, eps 1e-8,
    decoupled weight decay on every parameter), then the optional layer
    decay, all inside skip_on_nonfinite: when the gradients' global norm is
    not finite the step changes no parameter and no moment and counts one
    skip. Branchless: the decision stays on the device. A parameter
    without a gradient (a detached or unused one) takes a zero gradient,
    as jax.grad gives it, so weight decay still moves it.

    State: {'count', 'notfinite'} (int64 0-d), {'mu', 'nu'} (a tensor per
    parameter)."""

    def __init__(self, model, base_lr=1e-4, weight_decay=0.01,
                 clip_norm=35.0, backbone_lr_mult=0.1, total_iters=42_000,
                 warmup_iters=500, layer_decay=None, b1=0.9, b2=0.999,
                 eps=1e-8):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        labels = param_labels(self.names)
        self.groups = {g: [i for i, l in enumerate(labels) if l == g]
                       for g in ("backbone", "rest")}
        self.sched = {
            "rest": make_lr_schedule(base_lr, warmup_iters,
                                     total_iters=total_iters),
            "backbone": make_lr_schedule(base_lr * backbone_lr_mult,
                                         warmup_iters,
                                         total_iters=total_iters)}
        self.mults = None
        if layer_decay is not None:
            depth = len(model.img_backbone.blocks)
            self.mults = layer_decay_mults(self.names, layer_decay, depth)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self):
        dev = self.params[0].device
        z = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        return {"count": z(), "notfinite": z(),
                "mu": [torch.zeros_like(p) for p in self.params],
                "nu": [torch.zeros_like(p) for p in self.params]}

    @torch.no_grad()
    def step(self, state, grads):
        """Update the parameters and ``state`` in place from ``grads`` (one
        per parameter, None for none). Returns the gradients' global norm
        (0-d f32 tensor)."""
        dev = self.params[0].device
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        ok = torch.isfinite(norm)
        f32 = lambda v: const_vector((v,), torch.float32, dev)[0]
        one, zero = f32(1.0), f32(0.0)
        # non-finite step: zero gradients, moments kept (b = 1), no update
        for g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        clip = torch.where(norm < self.clip_norm, one,
                           self.clip_norm / norm)
        torch._foreach_mul_(grads, torch.where(ok, clip, zero))
        b1 = torch.where(ok, f32(self.b1), one)
        b2 = torch.where(ok, f32(self.b2), one)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(
            grads, torch.where(ok, f32(1 - self.b1), zero)))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads),
            torch.where(ok, f32(1 - self.b2), zero)))
        count = state["count"]
        new_count = count + ok.to(torch.int64)
        t = new_count.to(torch.float32)
        bc1 = torch.where(ok, 1 - f32(self.b1) ** t, one)
        bc2 = torch.where(ok, 1 - f32(self.b2) ** t, one)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        for group, idx in self.groups.items():
            if not idx:
                continue
            lr = torch.where(ok, -self.sched[group](count), zero)
            u = [upd[i] for i in idx]
            torch._foreach_mul_(u, lr)
            if self.mults is not None:
                torch._foreach_mul_(u, [self.mults[i] for i in idx])
            torch._foreach_add_([self.params[i] for i in idx], u)
        state["count"] = new_count
        state["notfinite"] = state["notfinite"] + (~ok).to(torch.int64)
        return norm


def make_optimizer(model, base_lr=1e-4, weight_decay=0.01, clip_norm=35.0,
                   backbone_lr_mult=0.1, total_iters=42_000,
                   warmup_iters=500, layer_decay=None) -> AdamW:
    """AdamW with backbone lr x0.1 (train.py:125-166)."""
    return AdamW(model, base_lr, weight_decay, clip_norm, backbone_lr_mult,
                 total_iters, warmup_iters, layer_decay)


class TrainState(NamedTuple):
    """The model (its parameters, updated in place), the optimizer state,
    the detached memory bank and the step."""
    model: ToC3DDetector
    opt_state: dict
    memory: MemoryBank
    step: int


def init_train_state(model, tx: AdamW, batch_size: int) -> TrainState:
    return TrainState(model, tx.init(),
                      init_memory(batch_size, model.cfg.head,
                                  next(model.parameters()).device), 0)


@torch.no_grad()
def build_train_packs(model: ToC3DDetector) -> None:
    """(Re)build the kernel-ready weight copies the step's kernels read:
    A's matrix, and B's and C's packs for the blocks that run them.
    cached_pack keys them on the parameters' versions, so after an
    optimizer step each is built anew here, without a graph, and the
    forward finds it built."""
    from ..ops.cuda.patch_embed import pack_patch_weight
    from ..ops.cuda.vit_block import pack_block_weights
    cfg = model.cfg
    bb = model.img_backbone
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    pack_patch_weight(bb.patch_embed.proj, dtype)
    for i, (blk, r) in enumerate(zip(bb.blocks,
                                     drop_path_rates(cfg.backbone))):
        if _accelerated(cfg, i) or r <= 0:
            pack_block_weights(blk, cfg.backbone.num_heads, dtype)


def batch_to_device(batch, device):
    """numpy / tensor batch -> tensors on ``device`` (floats as f32, ints as
    int64, bools as bool), and whether every lane continues its scene
    (read from the host copy, so no device read)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.float()
        elif t.dtype != torch.bool and t.dtype != torch.uint8:
            t = t.long()
        out[k] = t
    steady = bool((out["prev_exists"] > 0).all())
    return {k: t.to(device, non_blocking=True) for k, t in out.items()}, \
        steady


# ---------------------------------------------------------------------------
# loss assembly (one frame: the shipped ToC3D regime)
# ---------------------------------------------------------------------------

def _global_counts(outs, outs_roi, matched, batch, gt2_valid, dn, group):
    """The counts that couple a batch's lanes, summed over the ranks in one
    all-reduce: each decoder layer's positives, the DN targets, the 2D
    positives; and the number of ranks. The token-selection loss needs
    none: its weight is all ones, so its count is the mask's size, the
    same on every rank, and its local mean is already the global
    batch's."""
    q3 = outs["all_cls_scores"].shape[2]
    local = [positives(m, batch["gt_valid_3d"], q3) for m in matched[:-1]]
    local.append(dn["known_valid"].float().sum())
    local.append(scatter_rows(matched[-1], gt2_valid.float(),
                              outs_roi["enc_cls_scores"].shape[1],
                              0.0).sum())
    counts = torch.stack(local)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    return counts, dist.get_world_size(group)


def compute_losses(model: ToC3DDetector, memory: MemoryBank, batch,
                   noise: TrainNoise, remat: bool = True,
                   with_losses: bool = True, backbone_grad: bool = True,
                   steady=None, timer=None, group=None):
    """One frame's losses (train.py:173-262). batch, B-leading tensors on
    the model's device: img (B, N, H, W, 3), intrinsics / img2lidar (B, N,
    4, 4), timestamp (B,), ego_pose / ego_pose_inv (B, 4, 4), prev_exists
    (B,), gt_bboxes_3d (B, G3, 9) gravity-center, gt_labels_3d (B, G3),
    gt_valid_3d (B, G3), gt_bboxes_2d (B, N, G2, 4) xyxy px, gt_labels_2d
    (B, N, G2), gt_centers_2d (B, N, G2, 2), gt_valid_2d (B, N, G2).
    steady: all(prev_exists > 0) when the caller knows it from the host.
    timer: the spans 'forward', 'host matching' and 'losses'. group: the
    data-parallel process group, whose ranks' counts normalize the losses
    (_global_counts); None normalizes by this batch's. Returns (total,
    (loss dict, new bank)); the new bank is not detached here."""
    cfg = model.cfg
    with span(timer, "forward"):
        img = batch["img"]
        b, n = img.shape[:2]
        if cfg.use_grid_mask and noise.grid is not None:
            img = grid_mask(img, noise.grid)
        with torch.set_grad_enabled(backbone_grad and
                                    torch.is_grad_enabled()):
            feats, aux = extract_img_feat(
                model, img, memory, batch, steady=steady,
                mask_noise=noise.gumbel, train=True,
                dp_keep=noise.drop_path, remat=remat)
        fh, fw = feats.shape[2], feats.shape[3]
        locs = location_grid(fh, fw, cfg.stride, *cfg.pad_shape,
                             device=feats.device)
        outs_roi = focal_head_forward(model.img_roi_head, cfg.focal, feats,
                                      locs, cfg.focal.train_ratio)
        dn = prepare_for_dn(cfg.head, batch["gt_bboxes_3d"],
                            batch["gt_labels_3d"], batch["gt_valid_3d"],
                            noise.dn)
        dn_for_head = {
            "padded_reference_points": dn_reference_points(
                dn, model.pts_bbox_head.reference_points.weight, b),
            "attn_mask": dn["attn_mask"], "pad_size": dn["pad_size"]}
        data = {k: batch[k] for k in FRAME_KEYS}
        data["pad_shape"] = cfg.pad_shape
        outs, new_memory = head_forward(
            model.pts_bbox_head, cfg.head, feats, data, memory,
            topk_indexes=outs_roi["topk_indexes"], dn=dn_for_head,
            drop_masks=noise.dropout, remat=remat)
        if not with_losses:
            return torch.zeros((), device=feats.device), ({}, new_memory)
        g2 = batch["gt_bboxes_2d"].shape[2]
        gt2 = {k: batch[f"gt_{k}_2d"].reshape((b * n, g2)
                                              + batch[f"gt_{k}_2d"].shape[3:])
               for k in ("bboxes", "labels", "centers", "valid")}
        hc = cfg.head
        problems = [(cost_3d(outs["all_bbox_preds"][l],
                             outs["all_cls_scores"][l],
                             batch["gt_bboxes_3d"], batch["gt_labels_3d"],
                             batch["gt_valid_3d"], hc.code_weights),
                     batch["gt_valid_3d"])
                    for l in range(outs["all_cls_scores"].shape[0])]
        ph, pw = cfg.pad_shape
        problems.append((cost_2d(
            outs_roi["enc_bbox_preds"].float(),
            outs_roi["enc_cls_scores"].float(),
            outs_roi["pred_centers2d"].float(), gt2["bboxes"],
            gt2["labels"], gt2["centers"], gt2["valid"], (pw, ph)),
            gt2["valid"]))
    with span(timer, "host matching"):
        matched = hungarian_match(problems)
    with span(timer, "losses"):
        world, c3, c2 = 1, None, None
        if group is not None:
            counts, world = _global_counts(outs, outs_roi, matched, batch,
                                           gt2["valid"], dn, group)
            k = len(matched)          # the layers' and the DN counts
            c3, c2 = counts[:k], counts[k]
        losses = streampetr_loss(
            hc, outs, batch["gt_bboxes_3d"], batch["gt_labels_3d"],
            batch["gt_valid_3d"], dn=dn, matched=matched[:-1], counts=c3,
            world=world)
        losses.update(focal_head_loss(cfg.focal, outs_roi, gt2["bboxes"],
                                      gt2["labels"], gt2["centers"],
                                      gt2["valid"], cfg.pad_shape,
                                      matched=matched[-1], num_pos=c2,
                                      world=world))
        if aux["token_masks"]:
            masks = torch.stack([m[..., 0] for m in aux["token_masks"]])
            losses["semantic_loss"] = token_selection_loss(
                masks, gt2["bboxes"], gt2["valid"],
                patch_size=cfg.backbone.patch_size, loss_weight=5.0)
        total = sum(v.float() for v in losses.values())
    return total, (losses, new_memory)


def compute_losses_multiframe(model: ToC3DDetector, memory: MemoryBank,
                              batch, noises, remat: bool = True,
                              steady=None, timer=None, group=None):
    """Sliding-window multi-frame training (train.py:265-313; reference
    petr3d.py:262-308): batch arrays carry a T axis after B; noises: a
    TrainNoise per frame; steady: per frame, or None. The last
    cfg.num_frame_head_grads frames take head and neck gradients, the last
    num_frame_backbone_grads also backbone gradients, the last
    num_frame_losses give the losses, keyed 'frame_{t}_...'."""
    cfg = model.cfg
    t_total = batch["img"].shape[1]
    losses, totals = {}, []
    for t in range(t_total):
        frame = {k: v[:, t] for k, v in batch.items()}
        grad_frame = t >= t_total - cfg.num_frame_head_grads
        loss_frame = t >= t_total - cfg.num_frame_losses
        bb_grad = t >= t_total - cfg.num_frame_backbone_grads
        with torch.set_grad_enabled(grad_frame and torch.is_grad_enabled()):
            total, (ld, memory) = compute_losses(
                model, memory, frame, noises[t], remat=remat,
                with_losses=loss_frame, backbone_grad=bb_grad,
                steady=None if steady is None else steady[t], timer=timer,
                group=group)
        if not grad_frame:
            memory = MemoryBank(*(m.detach() for m in memory))
        if loss_frame:
            totals.append(total)
            for k, v in ld.items():
                losses[f"frame_{t}_{k}"] = v
    return sum(totals), (losses, memory)


def make_train_step(tx: AdamW, remat: bool = True, multiframe: bool = False,
                    group=None):
    """train_step(state, batch, noise, steady=None, timer=None) -> (state,
    metrics) (train.py:408-446): rebuild the kernels' weight packs, the
    losses, their backward, the optimizer. noise: the frame's TrainNoise
    (a list of them with multiframe, whose batch has a T axis after B).
    metrics: every loss, total_loss, grad_norm and nonfinite_skips, as 0-d
    tensors on the device (nothing is read back). timer
    (runtime/timer.StageTimer): the spans 'pack rebuild', 'forward', 'host
    matching', 'losses', 'backward', 'all-reduce' (with a group) and
    'optimizer'.

    group: a data-parallel process group (parallel/mesh.py). The batch,
    the noise and state.memory are then this rank's lanes, the losses are
    normalized by the ranks' summed counts, and the gradients are averaged
    over the ranks in ~25 MB buckets (mesh.BUCKET_BYTES) before the
    optimizer reads them. The metrics stay this rank's: each loss is W
    times its share, so their mean over the ranks (mesh.reduce_mean, read
    at the log interval) is the global batch's loss; grad_norm and
    nonfinite_skips are the same on every rank."""
    loss_fn = compute_losses_multiframe if multiframe else compute_losses
    reducer = None
    if group is not None:
        from ..parallel.mesh import GradReducer
        reducer = GradReducer(tx.params, group)

    def train_step(state: TrainState, batch, noise, steady=None,
                   timer=None):
        model = state.model
        with span(timer, "pack rebuild"):
            build_train_packs(model)
        for p in tx.params:
            p.grad = None
        total, (losses, new_memory) = loss_fn(
            model, state.memory, batch, noise, remat=remat, steady=steady,
            timer=timer, group=group)
        with span(timer, "backward"):
            total.backward()
        grads = [p.grad for p in tx.params]
        if reducer is not None:
            with span(timer, "all-reduce"):
                grads = reducer.reduce(grads)
        with span(timer, "optimizer"):
            grad_norm = tx.step(state.opt_state, grads)
        for p in tx.params:
            p.grad = None
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        metrics["nonfinite_skips"] = state.opt_state["notfinite"].clone()
        new_memory = MemoryBank(*(m.detach() for m in new_memory))
        return TrainState(model, state.opt_state, new_memory,
                          state.step + 1), metrics

    return train_step
