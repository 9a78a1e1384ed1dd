"""Hungarian set matching with static padded shapes (counterpart of
toc3d_tpu/core/assigner.py:28-208).

  HungarianAssigner3D -> reference hungarian_assigner_3d.py: FocalLossCost
      (2) + BBox3DL1Cost (0.25 over the code-weighted normalized boxes)
  HungarianAssigner2D -> reference hungarian_assigner_2d.py: FocalLossCost
      (2) + BBoxL1Cost (5, cxcywh) + IoUCost (giou, 2) + L1 on the
      normalized centers (10)

The cost terms are computed on the tensors' device. GT arrays are padded to
a static G with a validity mask; padded columns cost BIG_COST and are left
out of the solve. The assignment has two implementations, as in JAX
(assigner.py:62-88):

  'callback'  the host LAP: every cost tensor of the call goes to the host
              in one copy, the native solver (native/lap.cpp, one C call a
              tensor) solves it, and the answers come back in one copy, so
              a train step that matches six decoder layers and the 2D head
              waits for the device once. The default for CPU tensors.
  'auction'   Bertsekas' auction on the device (core/auction.py): one
              kernel launch a cost tensor, no host read. The default for
              CUDA tensors, as JAX's is on an accelerator.

``set_default_impl`` pins one for every call; ``lsa_host_scipy`` (scipy's
linear_sum_assignment, per sample) is kept as the tests' oracle and no path
calls it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.consts import const_vector
from .boxes import normalize_bbox
from .losses import _safe_pow, cxcywh_to_xyxy, giou_aligned, xyxy_to_cxcywh

BIG_COST = 1e6


def lsa_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Batched linear sum assignment on the host (assigner.py:28-60): cost
    (B, Q, G), n_valid (B,) -> (B, G) int32, for each GT slot its matched
    query (-1 for padded slots). One call of the native solver for the
    whole batch (native.lap_batched, on the transposed costs: rows are
    GTs)."""
    from ..native import lap_batched
    cost = np.nan_to_num(np.asarray(cost, np.float32), nan=100.0,
                         posinf=100.0, neginf=-100.0)
    return lap_batched(np.swapaxes(cost, 1, 2), np.asarray(n_valid))


def lsa_host_scipy(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """``lsa_host`` by per-sample scipy linear_sum_assignment, JAX's
    fallback (assigner.py:50-60); the tests' oracle only."""
    from scipy.optimize import linear_sum_assignment
    cost = np.nan_to_num(np.asarray(cost, np.float32), nan=100.0,
                         posinf=100.0, neginf=-100.0)
    b, _, g = cost.shape
    out = np.full((b, g), -1, np.int32)
    for i in range(b):
        nv = int(n_valid[i])
        if nv == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :nv])
        out[i, cols] = rows.astype(np.int32)
    return out


IMPLS = ("callback", "auction")
_IMPL_OVERRIDE = None


def set_default_impl(impl):
    """Pin the matcher of every ``hungarian_match`` call that names none:
    'callback', 'auction', or None for the per-device default
    (assigner.py:65-80)."""
    global _IMPL_OVERRIDE
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"matcher {impl!r}: expected one of {IMPLS}")
    _IMPL_OVERRIDE = impl


def resolve_impl(device=None) -> str:
    """The pinned matcher, else 'callback' for the CPU and 'auction' for a
    CUDA device (assigner.py:83-88: callback on CPU, auction on an
    accelerator)."""
    if _IMPL_OVERRIDE is not None:
        return _IMPL_OVERRIDE
    return "auction" if torch.device(device or "cpu").type == "cuda" \
        else "callback"


def _match_callback(problems):
    dev = problems[0][0].device
    with torch.no_grad():
        flat = torch.cat([t.detach().float().reshape(-1) for c, v in problems
                          for t in (c, v)])
        host = flat.cpu().numpy()
    out, at = [], 0
    for c, v in problems:
        b, q, g = c.shape
        cost = host[at:at + b * q * g].reshape(b, q, g)
        at += b * q * g
        valid = host[at:at + b * g].reshape(b, g) > 0
        at += b * g
        m = lsa_host(cost, valid.sum(axis=1))
        out.append(np.where(valid, m, -1).astype(np.int64))
    sizes = [m.size for m in out]
    joined = torch.from_numpy(np.concatenate([m.reshape(-1) for m in out]))
    if dev.type == "cuda":
        joined = joined.pin_memory().to(dev, non_blocking=True)
    res, at = [], 0
    for (c, _), n in zip(problems, sizes):
        res.append(joined[at:at + n].reshape(c.shape[0], c.shape[2]))
        at += n
    return res


def _match_auction(problems):
    from ..ops.cuda.auction import auction_match
    res = []
    with torch.no_grad():
        for c, v in problems:
            valid = v.detach().bool()
            m = auction_match(c.detach(), valid.sum(dim=1))
            res.append(torch.where(valid, m.long(),
                                   torch.full_like(m, -1, dtype=torch.long)))
    return res


def hungarian_match(problems, impl=None):
    """problems: a list of (cost (B, Q, G), gt_valid (B, G)) on one device.
    Returns a list of (B, G) int64 tensors there, the matched query of each
    GT slot, -1 where the slot is invalid. The costs are detached (the
    reference detaches them too, hungarian_assigner_3d.py:73). impl:
    'callback' (the host LAP, one copy each way for the whole list) or
    'auction' (on the device, one launch a cost tensor on CUDA); None
    takes ``resolve_impl`` of the tensors' device."""
    if not problems:
        return []
    impl = impl or resolve_impl(problems[0][0].device)
    if impl == "auction":
        return _match_auction(problems)
    if impl != "callback":
        raise ValueError(f"matcher {impl!r}: expected one of {IMPLS}")
    return _match_callback(problems)


def focal_cls_cost(cls_pred, gt_labels, weight=2.0, alpha=0.25, gamma=2.0,
                   eps=1e-12):
    """mmdet FocalLossCost, batched: cls_pred (B, Q, C) logits, gt_labels
    (B, G) -> (B, Q, G); logs of clipped arguments."""
    p = torch.sigmoid(cls_pred.float())
    neg = -torch.log((1 - p).clamp(min=eps)) * (1 - alpha) * _safe_pow(
        p, gamma)
    pos = -torch.log(p.clamp(min=eps)) * alpha * _safe_pow(1 - p, gamma)
    diff = pos - neg                                        # (B, Q, C)
    idx = gt_labels.long()[:, None, :].expand(-1, diff.shape[1], -1)
    return torch.gather(diff, 2, idx) * weight


def l1_cost(pred, target, weight):
    """(B, Q, D), (B, G, D) -> (B, Q, G) L1 distance."""
    return (pred[:, :, None] - target[:, None]).abs().sum(dim=-1) * weight


def giou_cost(pred_xyxy, target_xyxy, weight=2.0):
    """(B, Q, 4), (B, G, 4) -> (B, Q, G) -GIoU."""
    return -giou_aligned(pred_xyxy[:, :, None], target_xyxy[:, None]) * weight


def _mask_invalid(cost, gt_valid):
    return torch.where(gt_valid[:, None, :].bool(), cost,
                       torch.full_like(cost, BIG_COST))


def cost_3d(bbox_pred, cls_pred, gt_bboxes, gt_labels, gt_valid,
            match_costs, cls_weight=2.0, reg_weight=0.25, with_velo=False):
    """The 3D matching cost (assigner.py:135-166): bbox_pred (B, Q, 10)
    normalized code, cls_pred (B, Q, C) logits, gt (B, G, 9) gravity-center
    boxes, labels, valid -> (B, Q, G), BIG_COST at invalid slots."""
    mc = const_vector(match_costs, torch.float32, bbox_pred.device)
    cls_c = focal_cls_cost(cls_pred, gt_labels, weight=cls_weight)
    bp_w = bbox_pred.float() * mc
    gt_w = normalize_bbox(gt_bboxes.float()) * mc
    d = 10 if with_velo else 8
    reg_c = l1_cost(bp_w[..., :d], gt_w[..., :d], reg_weight)
    return _mask_invalid(cls_c + reg_c, gt_valid)


def cost_2d(bbox_pred, cls_pred, centers_pred, gt_bboxes, gt_labels,
            gt_centers, gt_valid, img_wh):
    """The 2D matching cost (assigner.py:173-208): bbox_pred (B, Q, 4)
    normalized cxcywh, cls_pred (B, Q, C), centers_pred (B, Q, 2)
    normalized, gt_bboxes (B, G, 4) xyxy px, gt_centers (B, G, 2) px,
    img_wh (w, h) -> (B, Q, G)."""
    w, h = img_wh
    factor = const_vector((w, h, w, h), torch.float32, bbox_pred.device)
    gt_cxcywh = xyxy_to_cxcywh(gt_bboxes / factor)
    cls_c = focal_cls_cost(cls_pred, gt_labels, weight=2.0)
    reg_c = l1_cost(bbox_pred, gt_cxcywh, 5.0)
    iou_c = giou_cost(cxcywh_to_xyxy(bbox_pred) * factor, gt_bboxes, 2.0)
    ctr_c = l1_cost(centers_pred, gt_centers / factor[:2], 10.0)
    return _mask_invalid(cls_c + reg_c + iou_c + ctr_c, gt_valid)


def assign_3d(bbox_pred, cls_pred, gt_bboxes, gt_labels, gt_valid,
              match_costs, cls_weight=2.0, reg_weight=0.25,
              with_velo=False):
    """Batched 3D Hungarian assignment -> matched query (B, G), -1
    invalid (hungarian_match's default matcher)."""
    cost = cost_3d(bbox_pred, cls_pred, gt_bboxes, gt_labels, gt_valid,
                   match_costs, cls_weight, reg_weight, with_velo)
    return hungarian_match([(cost, gt_valid)])[0]


def assign_2d(bbox_pred, cls_pred, centers_pred, gt_bboxes, gt_labels,
              gt_centers, gt_valid, img_wh):
    """Batched 2D Hungarian assignment -> matched query (B, G), -1
    invalid (hungarian_match's default matcher)."""
    cost = cost_2d(bbox_pred, cls_pred, centers_pred, gt_bboxes, gt_labels,
                   gt_centers, gt_valid, img_wh)
    return hungarian_match([(cost, gt_valid)])[0]


def one_hot(labels, num_classes: int):
    """F.one_hot of int labels in f32, labels == num_classes (background)
    all zero, as jax.nn.one_hot."""
    return F.one_hot(labels.long(), num_classes + 1)[..., :num_classes] \
        .float()
