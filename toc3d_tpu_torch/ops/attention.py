"""Attention ops (counterpart of toc3d_tpu/ops/attention.py).

eva_attention: EVA attention (separate q/k/v projections, q and v biases,
RoPE, optional index-gathered RoPE) as a plain path — the main path runs it
inside the block kernels (ops/cuda/vit_block.py).
mha: batch-first multi-head attention with torch nn.MultiheadAttention
semantics and parameter layout; its softmax core is the flash kernel
(ops/cuda/cross_attn.py), the projections are plain matmuls, or int8 linears
(quant='int8', attention.py:172-180 on quantize_decoder_params weights).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import lin, linear, quantize_linear
from .cuda import cached_pack, param_key
from .cuda.cross_attn import flash_attention_core
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


def mha(attn: MultiheadAttention, query, key, value, num_heads: int,
        quant: str = "none"):
    """query (B, Q, C), key/value (B, K, C) -> (B, Q, C). Eval decoder
    attention: no mask, no dropout (attention.py:144-180, fused route).
    quant 'int8': the four projections are int8 linears; the core stays
    on the flash kernel."""
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
    out = flash_attention_core(q.to(v.dtype).contiguous(),
                               k.to(v.dtype).contiguous(), v.contiguous(),
                               num_heads)
    return linear(out, *po)
