"""StreamPETR head losses: the per-layer Hungarian set loss and the
denoising loss (counterpart of toc3d_tpu/models/streampetr_loss.py;
reference streampetr_head.py:701-1047, loss, loss_single, dn_loss_single,
_get_target_single).

Matched query indices of -1 (padded GT slots) land on a dummy row that is
dropped (focal_head_loss.scatter_rows); the positives are summed over the
whole batch, the reference's reduce_mean across GPUs. Under data
parallelism the caller passes the counts summed over the ranks and the
world size W, and each rank's loss is W * (its sum) / max(global count, 1),
so the average of the ranks' gradients is the gradient of the global
batch's loss (runtime/train.compute_losses).
"""
from __future__ import annotations

import torch

from ..core.assigner import assign_3d, one_hot
from ..core.boxes import normalize_bbox
from ..core.losses import l1_loss, sigmoid_focal_loss
from ..ops.consts import const_vector
from .focal_head_loss import scatter_rows


def _box_loss(cfg, bbox_preds, targets, pos_w, avg):
    norm_t = normalize_bbox(targets.float())
    notnan = torch.isfinite(norm_t).all(dim=-1)
    cw = const_vector(cfg.code_weights, torch.float32, bbox_preds.device)
    w = pos_w[..., None] * cw * notnan[..., None]
    return l1_loss(bbox_preds.float(), torch.nan_to_num(norm_t), w, avg,
                   loss_weight=0.25)


def positives(matched, gt_valid, q: int):
    """The matched positives of one layer's assignment (B, G) over Q
    queries, as the loss counts them (a 0-d f32 tensor)."""
    return scatter_rows(matched, gt_valid.float(), q, 0.0).sum()


def loss_single(cfg, cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid,
                matched=None, num_pos=None, world=1):
    """One decoder layer's set loss: cls_scores (B, Q, C) logits, bbox_preds
    (B, Q, 10), gt (B, G, 9) gravity-center, labels (B, G), valid (B, G);
    matched (B, G) when already solved. num_pos: the positives summed over
    the ranks of a data-parallel step (``world`` of them); None counts this
    batch's."""
    b, q, _ = cls_scores.shape
    if matched is None:
        matched = assign_3d(bbox_preds, cls_scores, gt_bboxes, gt_labels,
                            gt_valid, cfg.code_weights, with_velo=False)
    labels = scatter_rows(matched, gt_labels.long(), q, cfg.num_classes)
    bbox_t = scatter_rows(matched, gt_bboxes.float(), q, 0.0)
    pos_w = scatter_rows(matched, gt_valid.float(), q, 0.0)
    if num_pos is None:
        num_pos = pos_w.sum()
    avg = num_pos.clamp(min=1.0) / world          # bg_cls_weight == 0
    label_w = torch.ones(b, q, dtype=torch.float32, device=cls_scores.device)
    loss_cls = sigmoid_focal_loss(cls_scores.float(),
                                  one_hot(labels, cfg.num_classes), label_w,
                                  avg, loss_weight=2.0)
    loss_bbox = _box_loss(cfg, bbox_preds, bbox_t, pos_w, avg)
    return torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)


def dn_loss_single(cfg, cls_scores, bbox_preds, known_labels, known_bboxs,
                   known_valid, num_tgt=None, world=1):
    """One layer's denoising loss (streampetr_head.py:881-937): predictions
    of the DN slots (B, P, ...), known labels (B, P) (num_classes =
    negative), boxes (B, P, 9), valid (B, P). num_tgt: the DN targets
    summed over the ranks (``world`` of them); None counts this batch's."""
    if num_tgt is None:
        num_tgt = known_valid.float().sum()
    cls_avg = (num_tgt * 3.14159 / 6 * cfg.split ** 3).clamp(min=1.0) / world
    loss_cls = sigmoid_focal_loss(cls_scores.float(),
                                  one_hot(known_labels, cfg.num_classes),
                                  known_valid.float(), cls_avg,
                                  loss_weight=2.0)
    loss_bbox = _box_loss(cfg, bbox_preds, known_bboxs, known_valid.float(),
                          num_tgt.clamp(min=1.0) / world)
    return (cfg.dn_weight * torch.nan_to_num(loss_cls),
            cfg.dn_weight * torch.nan_to_num(loss_bbox))


def streampetr_loss(cfg, outs, gt_bboxes, gt_labels, gt_valid, dn=None,
                    matched=None, counts=None, world=1):
    """Every layer's losses, keyed as the reference ('d{l}.' for all but the
    last layer). outs: head_forward's train outputs; matched: a list of
    the per-layer assignments (B, G) when already solved. counts: under
    data parallelism, each layer's positives and then the DN targets, each
    summed over the ``world`` ranks (an (L + 1,) tensor); None counts this
    batch's."""
    all_cls = outs["all_cls_scores"]
    all_box = outs["all_bbox_preds"]
    n_layers = all_cls.shape[0]
    losses = {}
    for lvl in range(n_layers):
        lc, lb = loss_single(cfg, all_cls[lvl], all_box[lvl], gt_bboxes,
                             gt_labels, gt_valid,
                             None if matched is None else matched[lvl],
                             None if counts is None else counts[lvl], world)
        key = "" if lvl == n_layers - 1 else f"d{lvl}."
        losses[f"{key}loss_cls"] = lc
        losses[f"{key}loss_bbox"] = lb
    if dn is not None and "dn_cls_scores" in outs:
        for lvl in range(n_layers):
            lc, lb = dn_loss_single(cfg, outs["dn_cls_scores"][lvl],
                                    outs["dn_bbox_preds"][lvl],
                                    dn["known_labels"], dn["known_bboxs"],
                                    dn["known_valid"],
                                    None if counts is None else counts[-1],
                                    world)
            key = "" if lvl == n_layers - 1 else f"d{lvl}."
            losses[f"{key}dn_loss_cls"] = lc
            losses[f"{key}dn_loss_bbox"] = lb
    return losses
