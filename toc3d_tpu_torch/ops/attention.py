"""Attention ops (counterpart of toc3d_tpu/ops/attention.py).

eva_attention: EVA attention (separate q/k/v projections, q and v biases,
RoPE, optional index-gathered RoPE) as a plain path — the main path runs it
inside the block kernels (ops/cuda/vit_block.py).
mha: batch-first multi-head attention with torch nn.MultiheadAttention
semantics and parameter layout; its softmax core is the flash kernel
(ops/cuda/cross_attn.py) as an autograd Function, or, under an attention
mask (the DN mask) or dropout with explicit masks, written out; the
projections are plain matmuls, or int8 linears (quant='int8',
attention.py:172-180 on quantize_decoder_params weights).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import lin, linear, quantize_linear
from .cuda import cached_pack, param_key
from .cuda.cross_attn import flash_attention
from .rope import apply_rope, apply_rope_select


def _split_heads(x, num_heads):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def eva_attention_preproj(attn, x, num_heads: int, rope_tables=None,
                          select_idx=None):
    """eva_attention up to the merged attention output before the
    O-projection (the int8 blocks' proj_in site, int8_calib.py:50-66)."""
    b, n, c = x.shape
    q = _split_heads(linear(x, attn.q_proj.weight, attn.q_bias), num_heads)
    k = _split_heads(linear(x, attn.k_proj.weight), num_heads)
    v = _split_heads(linear(x, attn.v_proj.weight, attn.v_bias), num_heads)
    if rope_tables is not None:
        cos, sin = rope_tables
        if select_idx is not None:
            q = apply_rope_select(q, cos, sin, select_idx).to(v.dtype)
            k = apply_rope_select(k, cos, sin, select_idx).to(v.dtype)
        else:
            q = apply_rope(q, cos, sin).to(v.dtype)
            k = apply_rope(k, cos, sin).to(v.dtype)
    scale = (c // num_heads) ** -0.5
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    return _merge_heads((w.float() @ v.float()).to(x.dtype))


def eva_attention(attn, x, num_heads: int, rope_tables=None, select_idx=None):
    """x: (B, N, C); attn: models.eva_vit.Attention. rope_tables: (cos, sin)
    tensors or None; select_idx: (B, N) table rows for the compressed path
    (attention.py:81-126)."""
    out = eva_attention_preproj(attn, x, num_heads, rope_tables, select_idx)
    return lin(attn.proj, out)


class MultiheadAttention(nn.Module):
    """Parameter container with torch nn.MultiheadAttention's names
    (in_proj_weight (3C, C), in_proj_bias, out_proj)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value):
        return mha(self, query, key, value, self.num_heads)


def quantize_mha(attn: MultiheadAttention):
    """The int8 packs (q, k, v, out) of one attention's projections
    (petr_transformer.py:109-110), cached on the module until its parameters
    change."""
    def build():
        w, b = attn.in_proj_weight, attn.in_proj_bias
        c = w.shape[1]
        return tuple(quantize_linear(w[i * c:(i + 1) * c],
                                     b[i * c:(i + 1) * c])
                     for i in range(3)) + (
            quantize_linear(attn.out_proj.weight, attn.out_proj.bias),)
    return cached_pack(attn, "int8", param_key(attn), build)


def dropout(x, keep_mask, rate: float):
    """Dropout with an explicit keep mask (petr_transformer.py:69-74):
    x / (1 - rate) where kept, else 0, in x's dtype; identity without a
    mask."""
    if keep_mask is None or rate <= 0.0:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def mha(attn: MultiheadAttention, query, key, value, num_heads: int,
        quant: str = "none", attn_mask=None, drop_mask=None,
        rate: float = 0.0):
    """query (B, Q, C), key/value (B, K, C) -> (B, Q, C)
    (attention.py:132-208). Without a mask and without dropout (eval, and
    training at dropout 0) the core is kernel D (FlashAttentionFn: the
    kernel forward, the model path's backward). attn_mask: bool (Q, K) or
    (B, Q, K), True = masked out (the DN mask); drop_mask: the keep mask of
    the attention probabilities (B, heads, Q, K), at ``rate``. With either,
    the core is written out: f32 logits, the mask as the most negative f32,
    softmax, dropout, then the weights in v.dtype times v. quant 'int8':
    the four projections are int8 linears (attention.py:172-180)."""
    c = query.shape[-1]
    if quant == "int8":
        pq, pk, pv, po = ((p, None) for p in quantize_mha(attn))
    else:
        w, b = attn.in_proj_weight, attn.in_proj_bias
        pq, pk, pv = ((w[i * c:(i + 1) * c], b[i * c:(i + 1) * c])
                      for i in range(3))
        po = (attn.out_proj.weight, attn.out_proj.bias)
    scale = (c // num_heads) ** -0.5
    q = linear(query, *pq) * scale
    k = linear(key, *pk)
    v = linear(value, *pv)
    if attn_mask is None and (drop_mask is None or rate <= 0.0):
        out = flash_attention(q.to(v.dtype), k.to(v.dtype), v, num_heads)
        return linear(out, *po)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    logits = qh.float() @ kh.float().transpose(-1, -2)
    if attn_mask is not None:
        neg = torch.finfo(torch.float32).min
        bias = torch.zeros(attn_mask.shape, dtype=torch.float32,
                           device=logits.device).masked_fill(attn_mask, neg)
        logits = logits + (bias[None, None] if bias.dim() == 2
                           else bias[:, None])
    weights = dropout(torch.softmax(logits, dim=-1), drop_mask, rate)
    out = weights.to(vh.dtype) @ vh
    return linear(_merge_heads(out), *po)
