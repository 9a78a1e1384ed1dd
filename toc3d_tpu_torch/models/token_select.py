"""Motion query-guided token selection (counterpart of
toc3d_tpu/models/token_select.py; reference toc3d_utils.py:90-360).

As in the JAX package: the first-frame score-MLP fallback is blended per
lane, score = mlp * (1 - prev) + query * prev, and the MLP runs only when
some lane has prev_exists == 0 (token_select.py:196-229; here a Python
branch); the eval token mask is the noiseless softmax, or with Gumbel noise
handed in as a tensor (the reference's stochastic eval mask); top-k is a
stable descending sort, so ties keep ascending index order like
lax.sort_key_val on -scores (token_select.py:255-268).

score_type 'attention' aggregates the token-query attention map with one
linear; 'score' concatenates each projected token with the mean of the
motion-aware queries and scores it with an MLPBlock (token_select.py:
154-166), and returns no attention map.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MLN, lin, ln, mln
from ..ops.consts import const_vector
from ..ops.posenc import (nerf_positional_encoding, pos2posemb1d,
                          pos2posemb3d)
from .common import MLPBlock, mlp_block

LN_EPS = 1e-5  # selector LNs are torch defaults


@dataclass(frozen=True)
class SelectorConfig:
    embed_dim: int = 1024
    query_dim: int = 256
    num_queries: int = 64
    ratio: float = 0.5
    attn_scale: bool = True
    use_mask: bool = True
    score_type: str = "attention"  # 'attention' | 'score'
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


class Selector(nn.Module):
    """MotionAwareQueryGuidedTokenSelector parameters with the reference
    names (in_conv/out_conv score MLP, input_proj, aggregate,
    query_embedding, ego_pose_pe, ego_pose_queries, time_embedding). The
    aggregate is aggregate.0, a Linear(num_queries, 2) for 'attention' and
    an MLPBlock(2 * query_dim, query_dim, 2) for 'score'
    (toc3d_utils.py:306-318)."""

    def __init__(self, cfg: SelectorConfig):
        super().__init__()
        c, qd = cfg.embed_dim, cfg.query_dim
        self.in_conv = nn.Sequential(nn.LayerNorm(c, eps=LN_EPS),
                                     nn.Linear(c, c), nn.GELU())
        self.out_conv = nn.Sequential(
            nn.Linear(c, c // 2), nn.GELU(), nn.Linear(c // 2, c // 4),
            nn.GELU(), nn.Linear(c // 4, 2))
        self.input_proj = nn.Sequential(nn.Linear(c, qd))
        if cfg.score_type == "attention":
            self.aggregate = nn.Sequential(nn.Linear(cfg.num_queries, 2))
        elif cfg.score_type == "score":
            self.aggregate = nn.Sequential(MLPBlock(2 * qd, qd, 2))
        else:
            raise ValueError(f"score_type {cfg.score_type!r}: 'attention' "
                             "or 'score'")
        self.query_embedding = nn.Sequential(
            nn.Linear(qd * 3 // 2, qd), nn.ReLU(), nn.Linear(qd, qd))
        self.ego_pose_pe = MLN(180, qd)
        self.ego_pose_queries = MLN(180, qd)
        self.time_embedding = nn.Sequential(nn.Linear(qd, qd),
                                            nn.LayerNorm(qd, eps=LN_EPS))


def score_mlp_forward(p: Selector, x):
    """x: (B, N, C) masked tokens -> (B, N, 2) log-softmax scores
    (toc3d_utils.py:114-129)."""
    h = F.gelu(lin(p.in_conv[1], ln(p.in_conv[0], x, LN_EPS)))
    c = h.shape[-1]
    local = h[..., :c // 2]
    glob = h[..., c // 2:].mean(dim=1, keepdim=True).expand_as(local)
    h = torch.cat([local, glob], dim=-1)
    h = F.gelu(lin(p.out_conv[0], h))
    h = F.gelu(lin(p.out_conv[2], h))
    return F.log_softmax(lin(p.out_conv[4], h), dim=-1)


def get_motion_aware_queries(p: Selector, cfg: SelectorConfig, temp_queries,
                             temp_ref_points, temp_vel, temp_timestamp,
                             temp_ego_pose, ego_pose_inv):
    """History queries conditioned on motion (toc3d_utils.py:334-360)."""
    from ..core.boxes import transform_reference_points
    pc = const_vector(cfg.pc_range, torch.float32, temp_queries.device)
    ref = transform_reference_points(temp_ref_points, ego_pose_inv)
    ref = (ref - pc[:3]) / (pc[3:6] - pc[:3])
    pos = pos2posemb3d(ref, num_pos_feats=cfg.query_dim // 2)
    pos = lin(p.query_embedding[2], F.relu(lin(p.query_embedding[0], pos)))
    ego_motion = torch.cat(
        [temp_vel, temp_timestamp,
         temp_ego_pose[..., :3, :].reshape(*temp_ego_pose.shape[:-2], 12)],
        dim=-1).float()
    ego_motion = nerf_positional_encoding(ego_motion)
    pos = mln(p.ego_pose_pe, pos, ego_motion)
    te = lin(p.time_embedding[0],
             pos2posemb1d(temp_timestamp, num_pos_feats=cfg.query_dim))
    pos = pos + ln(p.time_embedding[1], te, LN_EPS)
    q = mln(p.ego_pose_queries, temp_queries, ego_motion)
    return q + pos


def query_based_score(p: Selector, cfg: SelectorConfig, tokens, queries):
    """tokens (BN, N, C), queries (B, Q, Cq) -> ((BN, N, 2) log-softmax
    scores, the (BN, N, Q) attention for 'attention' or None for 'score')
    (toc3d_utils.py:232-252; token_select.py:133-166)."""
    bn, b = tokens.shape[0], queries.shape[0]
    x = lin(p.input_proj[0], tokens)
    q = queries.repeat_interleave(bn // b, dim=0)
    if cfg.score_type == "score":
        mean_q = q.mean(dim=1, keepdim=True).expand_as(x)
        logits = mlp_block(p.aggregate[0], torch.cat([x, mean_q], dim=-1))
        return F.log_softmax(logits, dim=-1), None
    scale = cfg.query_dim ** -0.5 if cfg.attn_scale else 1.0
    attn = torch.einsum("bnc,bqc->bnq", x.float(), q.float()) * scale
    logits = lin(p.aggregate[0], attn.to(x.dtype))
    return F.log_softmax(logits, dim=-1), attn


def selector_score(p: Selector, cfg: SelectorConfig, tokens_hw, mask,
                   motion_ctx, prev_exists, steady: Optional[bool] = None,
                   train_blend: bool = False):
    """tokens_hw (BN, H, W, C); mask (BN, H, W, 1) or None; motion_ctx: the
    memory-bank views (B-leading) and ego_pose_inv; prev_exists (B,).
    steady: whether every lane has prev_exists > 0 (computed here when not
    given; the detector passes it so the host reads it once per frame).
    train_blend: the training blend of the first-frame fallback, which
    keeps only channel 0 of the MLP score, broadcast over both channels
    (token_select.py:210-214; toc3d_utils.py:264-266).
    Returns (scores (BN, H*W), pred (BN, H*W, 2), attn or None)."""
    bn, h, w, c = tokens_hw.shape
    use_mask = cfg.use_mask and mask is not None
    x = tokens_hw.reshape(bn, h * w, c)
    if use_mask:
        x = x * mask.reshape(bn, h * w, 1).to(tokens_hw.dtype)
    queries = get_motion_aware_queries(
        p, cfg, motion_ctx["temp_queries"], motion_ctx["temp_ref_points"],
        motion_ctx["temp_vel"], motion_ctx["temp_timestamp"],
        motion_ctx["temp_ego_pose"], motion_ctx["ego_pose_inv"])
    q_score, attn = query_based_score(p, cfg, x, queries)
    if steady is None:
        steady = bool((prev_exists > 0).all())
    if steady:
        pred = q_score
    else:
        b = prev_exists.shape[0]
        pe = prev_exists.reshape(b, 1, 1, 1).to(q_score.dtype)
        pe = pe.expand(b, bn // b, 1, 1).reshape(bn, 1, 1)
        mlp_score = score_mlp_forward(p, x)
        if train_blend:
            mlp_score = mlp_score[..., :1]
        pred = mlp_score * (1.0 - pe) + q_score * pe
    return pred[..., 0], pred, attn


def keep_count(n: int, ratio: float, n_rep: int = 0,
               mxu_align: bool = False) -> int:
    """k = int(n * ratio) (toc3d_utils.py:131-143); with mxu_align, one
    token fewer when k + n_rep = 1 mod 128 (token_select.py:236-252)."""
    k = int(n * ratio)
    if mxu_align and k > 1 and (k + n_rep) % 128 == 1:
        k -= 1
    return k


def sample_topk(scores, ratio: float, k: Optional[int] = None):
    """scores (B, N) -> (keep scores, drop scores, keep idx, drop idx),
    stable descending: equal scores keep ascending index order."""
    n = scores.shape[-1]
    if k is None:
        k = int(n * ratio)
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], s[..., k:], idx[..., :k], idx[..., k:]


def hard_mask(scores, ratio: float):
    """The 0/1 eval mask of eval_mask 'hard' (toc3d_vit.py:276-281,
    toc3d_utils.py:150-157): 1 at the int(N * ratio) best tokens of the
    whole image (sample_topk), else 0. scores (B, N) -> (B, N, 1) in
    scores.dtype."""
    keep = sample_topk(scores, ratio)[2]
    mask = torch.zeros(*scores.shape, 1, dtype=scores.dtype,
                       device=scores.device)
    return mask.scatter_(1, keep[..., None], 1.0)


def gumbel_(out, generator):
    """Fill the f32 tensor ``out`` in place with standard Gumbel noise drawn
    from ``generator``: -log(-log(u)), u uniform in [tiny, 1), as
    jax.random.gumbel draws it. Returns out."""
    tiny = torch.finfo(torch.float32).tiny
    return out.uniform_(tiny, 1.0, generator=generator).log_().neg_() \
        .log_().neg_()


def soft_mask(pred_score, noise=None, tau: float = 1.0):
    """Keep-probability mask, channel 0 of the gumbel-softmax
    (token_select.py:277-285): softmax(pred / tau) without ``noise``, the
    deterministic eval mask; with it (f32 Gumbel noise of pred's shape,
    eval_mask 'gumbel'), softmax((f32(pred) + noise) / tau)."""
    logits = pred_score
    if noise is not None:
        logits = logits.float() + noise
    return torch.softmax(logits / tau, dim=-1)[..., 0:1].to(pred_score.dtype)
