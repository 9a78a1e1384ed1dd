"""Denoising (DN) query preparation with static shapes (counterpart of
toc3d_tpu/core/dn.py; reference streampetr_head.py:455-537,
prepare_for_dn).

The GT is padded to the static cfg.dn_max_gt; invalid slots carry zero
reference points and weight 0 in the DN loss. The noise is an explicit
tensor: ``rand_prob`` (B, scalar, G, 3), uniform in [-1, 1), the draw of
dn.py:46 (``draw_dn_noise`` draws it from a torch.Generator).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.consts import const_vector, device_const


def draw_dn_noise(cfg, batch: int, generator: torch.Generator, device,
                  gt=None) -> torch.Tensor:
    """The (B, scalar, G, 3) uniform [-1, 1) draw of prepare_for_dn, G the
    batch's padded GT count (cfg.dn_max_gt by default)."""
    g = cfg.dn_max_gt if gt is None else gt
    u = torch.empty(batch, cfg.scalar, g, 3, device=device)
    return u.uniform_(-1.0, 1.0, generator=generator)


def dn_attn_mask(cfg, pad_size: int, group_size: int, device):
    """(P + Q + propagated, P + Q + memory_len) bool, True = masked
    (streampetr_head.py:502-521): DN groups see no other DN group, the
    matching and propagated queries see no DN key."""
    def build():
        qs = pad_size + cfg.num_query + cfg.num_propagated
        ks = pad_size + cfg.num_query + cfg.memory_len
        qi = torch.arange(qs)
        ki = torch.arange(ks)
        q_group = torch.where(qi < pad_size, qi // group_size,
                              torch.full_like(qi, -1))
        k_group = torch.where(ki < pad_size, ki // group_size,
                              torch.full_like(ki, -1))
        dn_q = q_group[:, None] >= 0
        dn_k = k_group[None, :] >= 0
        return ((dn_q & dn_k & (q_group[:, None] != k_group[None, :]))
                | (~dn_q & dn_k))
    return device_const(("dn_attn_mask", pad_size, group_size,
                         cfg.num_query, cfg.num_propagated, cfg.memory_len),
                        device, build)


def prepare_for_dn(cfg, gt_bboxes, gt_labels, gt_valid,
                   rand_prob) -> Dict:
    """Noised DN reference points and the attention mask.

    gt_bboxes (B, G, >=7) gravity-center boxes (padded to G, as the loader
    pads to cfg.dn_max_gt), gt_labels (B, G) int, gt_valid (B, G) bool;
    rand_prob (B, scalar, G, 3) uniform in [-1, 1). Returns known_ref (B,
    P, 3) with P = scalar * G, attn_mask, pad_size P, known_labels (B, P),
    known_bboxs (B, P, D), known_valid (B, P) (dn.py:19-88)."""
    b, g = gt_labels.shape
    s = cfg.scalar
    p = s * g
    dev = gt_bboxes.device
    pc = const_vector(cfg.pc_range, torch.float32, dev)
    center = gt_bboxes[..., :3].float()[:, None].expand(b, s, g, 3)
    scale = gt_bboxes[..., 3:6].float()[:, None].expand(b, s, g, 3)
    labels = gt_labels.long()[:, None].expand(b, s, g)
    diff = scale / 2 + cfg.noise_trans
    noised = center + rand_prob * diff * cfg.noise_scale
    noised = ((noised - pc[0:3]) / (pc[3:6] - pc[0:3])).clamp(0.0, 1.0)
    flip = torch.linalg.vector_norm(rand_prob, dim=-1) > cfg.split
    labels = torch.where(flip, torch.full_like(labels, cfg.num_classes),
                         labels)
    valid = gt_valid.bool()[:, None].expand(b, s, g)
    noised = torch.where(valid[..., None], noised, torch.zeros_like(noised))
    known_bboxs = gt_bboxes[:, None].expand(
        (b, s) + tuple(gt_bboxes.shape[1:])).reshape(b, p,
                                                    gt_bboxes.shape[-1])
    return {
        "known_ref": noised.reshape(b, p, 3),
        "attn_mask": dn_attn_mask(cfg, p, g, dev),
        "pad_size": p,
        "known_labels": labels.reshape(b, p),
        "known_bboxs": known_bboxs,
        "known_valid": valid.reshape(b, p),
    }


def dn_reference_points(dn: Dict, reference_points, batch_size: int):
    """The DN reference points, then the learnable query ones (Q, 3)
    (streampetr_head.py:492-499) -> (B, P + Q, 3)."""
    q_ref = reference_points[None].expand(
        (batch_size,) + tuple(reference_points.shape))
    return torch.cat([dn["known_ref"], q_ref], dim=1)
