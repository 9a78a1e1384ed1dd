"""FocalHead: the per-view 2D auxiliary head of training (counterpart of
toc3d_tpu/models/focal_head.py; reference focal_head.py:119-193).

Its forward is training only (aux_2d_only: inference skips it,
petr3d.py:319-320): 2D class logits, centerness, ltrb boxes and 2D centers
per token, and the focal-sampling ranking of the tokens (``topk_indexes``)
that orders the 3D decoder's memory. The module holds the reference names
(shared_cls / shared_reg conv + GroupNorm, cls, centerness, ltrb,
center2d), so reference checkpoints load strictly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import inverse_sigmoid


@dataclass(frozen=True)
class FocalHeadConfig:
    """focal_head.py:19-26."""
    num_classes: int = 10
    in_channels: int = 256
    embed_dims: int = 256
    stride: int = 16
    train_ratio: float = 1.0
    infer_ratio: float = 1.0


class FocalHeadParams(nn.Module):
    """img_roi_head parameters (reference focal_head.py:119-193 names)."""

    def __init__(self, cfg: FocalHeadConfig):
        super().__init__()
        e = cfg.embed_dims
        self.shared_cls = nn.Sequential(
            nn.Conv2d(cfg.in_channels, e, 3, padding=1), nn.GroupNorm(32, e))
        self.shared_reg = nn.Sequential(
            nn.Conv2d(cfg.in_channels, e, 3, padding=1), nn.GroupNorm(32, e))
        self.cls = nn.Conv2d(e, cfg.num_classes, 1)
        self.centerness = nn.Conv2d(e, 1, 1)
        self.ltrb = nn.Conv2d(e, 4, 1)
        self.center2d = nn.Conv2d(e, 2, 1)


def _conv(mod: nn.Conv2d, x):
    """Channel-last conv in x's dtype (layers.conv2d)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), mod.weight.to(x.dtype),
                 mod.bias.to(x.dtype), padding=mod.padding)
    return y.permute(0, 2, 3, 1)


def group_norm(mod: nn.GroupNorm, x, eps: float = 1e-5):
    """Channel-last GroupNorm with f32 statistics (layers.py:149-163)."""
    dt = x.dtype
    lead, c = x.shape[0], x.shape[-1]
    g = mod.num_groups
    xg = x.float().reshape(lead, -1, g, c // g)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * mod.weight.float() + mod.bias.float()).to(dt)


def apply_ltrb(locations, pred_ltrb):
    """locations (h, w, 2) normalized; pred_ltrb (BN, h, w, 4) sigmoid ->
    cxcywh boxes in [0, 1] (misc.py:26-43)."""
    x1 = locations[..., 0] - pred_ltrb[..., 0]
    y1 = locations[..., 1] - pred_ltrb[..., 1]
    x2 = locations[..., 0] + pred_ltrb[..., 2]
    y2 = locations[..., 1] + pred_ltrb[..., 3]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).clamp(0.0, 1.0)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([cx, cy, w, h], dim=-1)


def apply_center_offset(locations, center_offset):
    """misc.py:45-56."""
    loc = inverse_sigmoid(locations)
    return torch.sigmoid(torch.stack([loc[..., 0] + center_offset[..., 0],
                                      loc[..., 1] + center_offset[..., 1]],
                                     dim=-1))


def stable_topk(x, k: int):
    """Indices of the k largest entries of each row of x, ties in
    ascending index order, as lax.top_k orders them."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def focal_head_forward(head: FocalHeadParams, cfg: FocalHeadConfig, feats,
                       locations, sample_ratio: float):
    """feats (B, N, h, w, C) channel-last; locations (h, w, 2) normalized
    (focal_head.py:76-115). Returns enc_cls_scores, enc_bbox_preds,
    pred_centers2d, centerness (all (B*N, h*w, ...)) and topk_indexes
    (B, K, 1)."""
    b, n, h, w, c = feats.shape
    x = feats.reshape(b * n, h, w, c)
    num_tokens = n * h * w
    num_sample = int(num_tokens * sample_ratio)
    cls_feat = F.relu(group_norm(head.shared_cls[1],
                                 _conv(head.shared_cls[0], x)))
    cls_logits = _conv(head.cls, cls_feat).reshape(b * n, h * w,
                                                   cfg.num_classes)
    centerness = _conv(head.centerness, cls_feat).reshape(b * n, h * w, 1)
    reg_feat = F.relu(group_norm(head.shared_reg[1],
                                 _conv(head.shared_reg[0], x)))
    ltrb = torch.sigmoid(_conv(head.ltrb, reg_feat))
    c2d_off = _conv(head.center2d, reg_feat)
    pred_bboxes = apply_ltrb(locations, ltrb).reshape(b * n, h * w, 4)
    pred_centers2d = apply_center_offset(locations, c2d_off).reshape(
        b * n, h * w, 2)
    cls_score = cls_logits.detach().amax(dim=-1).reshape(b, num_tokens)
    sample_weight = (torch.sigmoid(cls_score) * torch.sigmoid(
        centerness.detach().reshape(b, num_tokens)))
    topk_indexes = stable_topk(sample_weight, num_sample)
    return {"enc_cls_scores": cls_logits, "enc_bbox_preds": pred_bboxes,
            "pred_centers2d": pred_centers2d, "centerness": centerness,
            "topk_indexes": topk_indexes[..., None]}
