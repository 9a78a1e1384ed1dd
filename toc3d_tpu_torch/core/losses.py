"""Loss primitives, static-shape and mask-weighted, with mmdet semantics
(counterpart of toc3d_tpu/core/losses.py).

  sigmoid focal loss    -> reference models/losses/focal_loss.py:10-102
  L1 / weight-reduce    -> mmdet l1_loss, models/losses/utils.py
  GaussianFocalLoss     -> mmdet (alpha 2, gamma 4): token selection and
                           the FocalHead centerness
  QualityFocalLoss      -> mmdet (beta 2): the FocalHead classes
  GIoU                  -> mmdet giou_loss
  TokenSelectionLoss    -> reference models/losses/token_selection_loss.py

Every loss takes elementwise weights and an avg_factor (a number or a
0-d tensor, so nothing is read back to the host); padded entries carry
weight 0. The logs clip their arguments, log(clip(1 - x, eps)), not the
additive 1 - x + eps (losses.py:92-103), so no inf meets a zero weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _clamp_min(v, lo):
    if isinstance(v, torch.Tensor):
        return v.clamp(min=lo)
    return max(v, lo)


def weight_reduce_sum(loss, weight, avg_factor):
    """sum(loss * weight) / avg_factor (mmdet weight_reduce_loss, 'mean'
    with an explicit avg_factor)."""
    return (loss * weight).sum() / _clamp_min(avg_factor, 1e-12)


def _safe_pow(x, p):
    """x ** p with integral p as an integer power (losses.py:31-37)."""
    return x ** int(p) if float(p).is_integer() else x ** p


def _bce_with_logits(logits, targets):
    """Numerically stable BCE, as F.binary_cross_entropy_with_logits."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(pred, target_onehot, weight, avg_factor, gamma=2.0,
                       alpha=0.25, loss_weight=2.0):
    """pred (..., C) logits; target_onehot (..., C) in {0, 1}; weight (...)
    per anchor; in f32 whatever pred's dtype (mmcv force_fp32)."""
    pred = pred.float()
    p = torch.sigmoid(pred)
    t = target_onehot.to(p.dtype)
    pt = (1 - p) * t + p * (1 - t)
    focal_weight = (alpha * t + (1 - alpha) * (1 - t)) * _safe_pow(pt, gamma)
    loss = _bce_with_logits(pred, t) * focal_weight
    return loss_weight * weight_reduce_sum(loss, weight[..., None],
                                           avg_factor)


def quality_focal_loss(pred, labels, quality, weight, avg_factor,
                       num_classes, beta=2.0, loss_weight=2.0):
    """mmdet QualityFocalLoss: pred (N, C) logits, labels (N,) int
    (num_classes = background), quality (N,) IoU of positives."""
    pred = pred.float()
    p = torch.sigmoid(pred)
    loss = _bce_with_logits(pred, torch.zeros_like(pred)) * _safe_pow(p, beta)
    pos = labels < num_classes
    lab = torch.where(pos, labels, torch.zeros_like(labels))
    onehot = F.one_hot(lab.long(), num_classes).to(pred.dtype)
    q = quality[..., None].to(pred.dtype)
    pos_loss = (_bce_with_logits(pred, q * onehot)
                * _safe_pow((q * onehot - p).abs(), beta))
    loss = torch.where(pos[..., None] & (onehot > 0), pos_loss, loss)
    return loss_weight * weight_reduce_sum(loss, weight[..., None],
                                           avg_factor)


def gaussian_focal_loss(pred, target, weight, avg_factor=None, alpha=2.0,
                        gamma=4.0, loss_weight=1.0, eps=1e-12):
    """mmdet GaussianFocalLoss, pred in (0, 1), gaussian-heatmap target;
    f32, integer powers, clipped logs, branches picked by where."""
    pred = pred.float()
    target = target.float()
    neg_w = _safe_pow(1 - target, gamma)
    log_p = torch.log(pred.clamp(min=eps))
    log_q = torch.log((1.0 - pred).clamp(min=eps))
    pos_loss = -log_p * _safe_pow(1 - pred, alpha)
    neg_loss = -log_q * _safe_pow(pred, alpha) * neg_w
    loss = torch.where(target == 1.0, pos_loss, neg_loss)
    if avg_factor is None:
        return loss_weight * (loss * weight).sum() / (
            (weight > 0).to(loss.dtype).sum().clamp(min=1.0))
    return loss_weight * weight_reduce_sum(loss, weight, avg_factor)


def l1_loss(pred, target, weight, avg_factor, loss_weight=1.0):
    return loss_weight * weight_reduce_sum((pred - target).abs(), weight,
                                           avg_factor)


def clip_sigmoid(x, eps=1e-4):
    """mmdet3d clip_sigmoid (models/utils/clip_sigmoid.py:5)."""
    return torch.sigmoid(x).clamp(eps, 1 - eps)


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _inter_union(a, b, eps):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter, (area_a + area_b - inter).clamp(min=eps)


def bbox_overlaps_aligned(a, b, eps=1e-6):
    """IoU of aligned xyxy box pairs (..., 4) -> (...)."""
    inter, union = _inter_union(a, b, eps)
    return inter / union


def giou_aligned(a, b, eps=1e-7):
    """GIoU of aligned xyxy pairs -> (...)."""
    inter, union = _inter_union(a, b, eps)
    iou = inter / union
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    enclose = (wh[..., 0] * wh[..., 1]).clamp(min=eps)
    return iou - (enclose - union) / enclose


def giou_loss(pred_xyxy, target_xyxy, weight, avg_factor, loss_weight=2.0):
    loss = 1.0 - giou_aligned(pred_xyxy, target_xyxy)
    return loss_weight * weight_reduce_sum(loss, weight, avg_factor)


def kl_div_loss(pred_log_probs, target_probs, weight=None, avg_factor=None,
                loss_weight=1.0):
    """KL divergence, batchmean (reference models/losses/kl_loss.py)."""
    loss = target_probs * (torch.log(target_probs.clamp(min=1e-12))
                           - pred_log_probs)
    if weight is not None:
        loss = loss * weight
    denom = (_clamp_min(avg_factor, 1e-12) if avg_factor is not None
             else pred_log_probs.shape[0])
    return loss_weight * loss.sum() / denom


def token_selection_targets(gt_bboxes2d, gt_valid, mask_h, mask_w,
                            patch_size=16, bg_mask_value=0.0):
    """2D GT boxes (V, G, 4) xyxy px rasterized to the patch grid, valid
    (V, G) -> (V, mask_h, mask_w): 1 inside any box, bg_mask_value
    outside, half-open [tl, br) as the reference slices
    (token_selection_loss.py:22-51)."""
    tl_x = torch.floor(gt_bboxes2d[..., 0] / patch_size).clamp(min=0)
    tl_y = torch.floor(gt_bboxes2d[..., 1] / patch_size).clamp(min=0)
    br_x = torch.ceil(gt_bboxes2d[..., 2] / patch_size).clamp(max=mask_w - 1)
    br_y = torch.ceil(gt_bboxes2d[..., 3] / patch_size).clamp(max=mask_h - 1)
    dev = gt_bboxes2d.device
    ys = torch.arange(mask_h, dtype=torch.float32, device=dev)
    xs = torch.arange(mask_w, dtype=torch.float32, device=dev)
    in_y = (ys >= tl_y[..., None]) & (ys < br_y[..., None])
    in_x = (xs >= tl_x[..., None]) & (xs < br_x[..., None])
    inside = in_y[..., :, None] & in_x[..., None, :]          # (V, G, H, W)
    inside = inside & gt_valid[..., None, None].bool()
    ones = torch.ones((), dtype=torch.float32, device=dev)
    return torch.where(inside.any(dim=1), ones,
                       torch.full_like(ones, bg_mask_value))


def token_selection_loss(pred_masks, gt_bboxes2d, gt_valid, patch_size=16,
                         loss_weight=5.0, bg_mask_value=0.0):
    """pred_masks (L, V, H, W) soft keep probabilities; gt_bboxes2d
    (V, G, 4); gt_valid (V, G)."""
    l, v, h, w = pred_masks.shape
    target = token_selection_targets(gt_bboxes2d, gt_valid, h, w, patch_size,
                                     bg_mask_value)
    target = target[None].expand(pred_masks.shape)
    weight = torch.ones(pred_masks.shape, dtype=torch.float32,
                        device=pred_masks.device)
    return gaussian_focal_loss(pred_masks, target, weight, avg_factor=None,
                               loss_weight=loss_weight)
