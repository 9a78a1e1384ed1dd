"""Decomposed relative position embeddings (MViTv2-style) for ViT attention
(counterpart of toc3d_tpu/ops/rel_pos.py; reference eva_utils.py:136-226).
The EVA backbone's use_rel_pos capability; the shipped configs use RoPE.

A table of the wanted length is gathered on its own device (differentiable);
a table of another length is first resized on the host by the log-spaced
cubic interpolation (scipy, imported at the call), as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch


def _log_interp_rel_pos(rel_pos: np.ndarray, dst_size: int) -> np.ndarray:
    """Log-spaced cubic resize of a (L, C) table (eva_utils.py:160-185,
    q = 1.0903078)."""
    from scipy import interpolate

    src_size = rel_pos.shape[0]
    q = 1.0903078
    dis, cur = [], 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    x = [-d for d in reversed(dis)] + [0] + dis
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)
    cols = [interpolate.interp1d(x, rel_pos[:, i], kind="cubic",
                                 fill_value="extrapolate")(dx).reshape(-1, 1)
            for i in range(rel_pos.shape[1])]
    return np.concatenate(cols, axis=-1).astype(np.float32)


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """(L, C) table (tensor or array) -> (q_size, k_size, C) embeddings
    (eva_utils.py:136-194), a tensor on the table's device."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    rel_pos = torch.as_tensor(rel_pos)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = torch.from_numpy(_log_interp_rel_pos(
            rel_pos.detach().float().cpu().numpy(), max_rel_dist)).to(
                rel_pos.device)
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)
    return rel_pos[idx]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """attn (B, q_h*q_w, k_h*k_w); q (B, q_h*q_w, C) -> attn plus the
    decomposed height and width terms (eva_utils.py:197-226)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    b = q.shape[0]
    r_q = q.reshape(b, q_h, q_w, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.reshape(b, q_h, q_w, k_h, k_w)
    attn = attn + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, q_h * q_w, k_h * k_w)
