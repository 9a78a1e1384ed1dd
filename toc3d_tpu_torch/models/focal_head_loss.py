"""FocalHead 2D auxiliary losses (counterpart of
toc3d_tpu/models/focal_head_loss.py; reference focal_head.py:195-531) with
the shipped weights: QualityFocalLoss 2.0, GaussianFocalLoss centerness 1.0,
L1 boxes 5.0, GIoU 2.0, L1 centers 10.0. GT is padded per view: (V, G, ...)
with a validity mask, V = B * views.
"""
from __future__ import annotations

import torch

from ..core.assigner import assign_2d
from ..core.losses import (bbox_overlaps_aligned, clip_sigmoid,
                           cxcywh_to_xyxy, gaussian_focal_loss, giou_loss,
                           l1_loss, quality_focal_loss, xyxy_to_cxcywh)
from ..ops.consts import const_vector


def gaussian_heatmap_targets(centers, bboxes, valid, h, w, stride=16):
    """Max-combined gaussian splats (focal_head.py:372-385): centers (V, G,
    2) px, bboxes (V, G, 4) xyxy px, valid (V, G) -> (V, h, w)."""
    l = centers[..., 0] - bboxes[..., 0]
    t = centers[..., 1] - bboxes[..., 1]
    r = bboxes[..., 2] - centers[..., 0]
    b = bboxes[..., 3] - centers[..., 1]
    radius = torch.ceil(torch.stack([l, t, r, b], -1).amin(-1) / stride)
    radius = radius.clamp(min=1.0)                          # (V, G)
    sigma = (2 * radius + 1) / 6.0
    cx = torch.floor(centers[..., 0] / stride)
    cy = torch.floor(centers[..., 1] / stride)
    dev = centers.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    dx = xs - cx[..., None]                                 # (V, G, w)
    dy = ys - cy[..., None]                                 # (V, G, h)
    val = torch.exp(-(dx[:, :, None, :] ** 2 + dy[:, :, :, None] ** 2)
                    / (2 * sigma[..., None, None] ** 2))    # (V, G, h, w)
    rr = radius[..., None, None]
    inside = (dx[:, :, None, :].abs() <= rr) & (dy[:, :, :, None].abs() <= rr)
    val = torch.where(inside & valid.bool()[..., None, None], val,
                      torch.zeros_like(val))
    return val.amax(dim=1)


def scatter_rows(matched, values, q: int, fill):
    """Write values (V, G, ...) at rows ``matched`` (V, G) of a (V, q, ...)
    array of ``fill``, invalid slots (-1) onto a dummy row q that is then
    dropped (the static-shape scatter of streampetr_loss.py:18-37)."""
    v, g = matched.shape
    rest = tuple(values.shape[2:])
    safe = torch.where(matched >= 0, matched, torch.full_like(matched, q))
    out = torch.full((v, q + 1) + rest, fill, dtype=values.dtype,
                     device=values.device)
    idx = safe.reshape(v, g, *([1] * len(rest))).expand((v, g) + rest)
    return out.scatter(1, idx, values)[:, :q]


def focal_head_loss(cfg, outs, gt_bboxes2d, gt_labels2d, gt_centers2d,
                    gt_valid2d, pad_shape, matched=None, num_pos=None,
                    world=1):
    """outs: focal_head_forward's dict; GT padded per view (V, G, ...);
    pad_shape (pad_h, pad_w); matched: the 2D assignment (V, G) when the
    caller has solved it (runtime/train.compute_losses solves every
    assignment of a step at once), else solved here. num_pos: under data
    parallelism the positives summed over the ``world`` ranks (each
    rank's loss is then W * its sum / max(global count, 1)); None counts
    this batch's."""
    cls_scores = outs["enc_cls_scores"].float()
    bbox_preds = outs["enc_bbox_preds"].float()
    centers_pred = outs["pred_centers2d"].float()
    centerness = outs["centerness"].float()
    v, q, _ = cls_scores.shape
    ph, pw = pad_shape
    dev = cls_scores.device
    factor = const_vector((pw, ph, pw, ph), torch.float32, dev)
    if matched is None:
        matched = assign_2d(bbox_preds, cls_scores, centers_pred,
                            gt_bboxes2d, gt_labels2d, gt_centers2d,
                            gt_valid2d, (pw, ph))
    gt_cxcywh = xyxy_to_cxcywh(gt_bboxes2d / factor)
    gt_ctr_n = gt_centers2d / factor[:2]
    labels = scatter_rows(matched, gt_labels2d.long(), q, cfg.num_classes)
    bbox_t = scatter_rows(matched, gt_cxcywh.float(), q, 0.0)
    ctr_t = scatter_rows(matched, gt_ctr_n.float(), q, 0.0)
    pos_w = scatter_rows(matched, gt_valid2d.float(), q, 0.0)
    if num_pos is None:
        num_pos = pos_w.sum()
    num_pos = num_pos.clamp(min=1.0) / world

    pred_xyxy = cxcywh_to_xyxy(bbox_preds) * factor
    gt_xyxy = cxcywh_to_xyxy(bbox_t) * factor
    loss_iou = giou_loss(pred_xyxy, gt_xyxy, pos_w, num_pos, loss_weight=2.0)
    iou_score = bbox_overlaps_aligned(gt_xyxy, pred_xyxy).detach()
    label_w = torch.ones(v, q, dtype=torch.float32, device=dev)
    loss_cls = quality_focal_loss(cls_scores, labels, iou_score, label_w,
                                  num_pos, cfg.num_classes, beta=2.0,
                                  loss_weight=2.0)
    fh, fw = ph // cfg.stride, pw // cfg.stride
    heat = gaussian_heatmap_targets(gt_centers2d, gt_bboxes2d, gt_valid2d,
                                    fh, fw, cfg.stride)
    loss_ctr = gaussian_focal_loss(
        clip_sigmoid(centerness[..., 0]), heat.reshape(v, -1),
        torch.ones(v, fh * fw, dtype=torch.float32, device=dev), num_pos,
        loss_weight=1.0)
    loss_bbox = l1_loss(bbox_preds, bbox_t, pos_w[..., None], num_pos,
                        loss_weight=5.0)
    loss_centers = l1_loss(centers_pred, ctr_t, pos_w[..., None], num_pos,
                           loss_weight=10.0)
    return {
        "enc_loss_cls": torch.nan_to_num(loss_cls),
        "enc_loss_bbox": torch.nan_to_num(loss_bbox),
        "enc_loss_iou": torch.nan_to_num(loss_iou),
        "centers2d_losses": torch.nan_to_num(loss_centers),
        "centerness_losses": torch.nan_to_num(loss_ctr),
    }
