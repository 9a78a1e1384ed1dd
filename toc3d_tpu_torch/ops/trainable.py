"""Kernels A, B and C as autograd Functions, and the model path their
backward differentiates (counterpart of toc3d_tpu/ops/pallas/vit_block.py
:: make_trainable_full_block :964 and make_trainable_compressed_block :989,
and of toc3d_tpu/models/eva_vit.py :: _patch_embed_fused :125-143; kernel
D's Function is ops/cuda/cross_attn.FlashAttentionFn).

The kernels have no hand-written backward, in the JAX package neither
(vit_block.py:926-932). Each Function's forward launches the kernel
through its wrapper (on a CPU tensor, the wrapper's plain version) and
saves only its inputs, so a kernel block is its own remat. Its backward
recomputes the block through the model path with autograd at those inputs
and returns the vjp to the input, the block's parameters and, for C, the
scores.

The model path restates JAX's XLA block (eva_vit.py:269-288 and
toc3d_vit.py:113-177) over the modules' nn.Parameters: F.linear /
matmuls, layer_norm, the attention written out. It is not the kernels'
plain version (ops/cuda/*_plain), which stays the oracle the kernels are
held to. The full blocks with stochastic depth run this path in the
forward too (toc3d_vit.py:184-193: droppath lives inside the residuals).

Two things to know:
* C's backward routes the tokens by the forward's CompressPlan, never by a
  second top-k: routing is a top-k over near ties.
* The model path pads a full block's windows after LN1, as the reference
  and JAX's XLA path do; kernel B, like the TPU kernel, normalizes the
  zero pad tokens (LN(0)). Where a map does not tile into windows, the
  forward and the backward therefore linearize slightly different
  functions at the padded windows, as JAX's custom VJP does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..layers import ln, swiglu
from .attention import eva_attention
from .cuda.patch_embed import pack_patch_weight, patchify_matmul
from .cuda.vit_block import (LN_EPS, compress_plan, fused_compressed_block,
                             fused_full_block)
from .gather import batch_index_select, merge_tokens
from .window import window_partition, window_unpartition


def drop_path(x, keep, rate: float):
    """Stochastic depth on a residual delta with an explicit per-sample
    keep mask (B,) (eva_vit.py:251-260): x / (1 - rate) where kept, else
    0; identity without a mask or at rate 0."""
    if keep is None or rate <= 0.0:
        return x
    k = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(k, x / (1.0 - rate), torch.zeros_like(x))


def full_block_model(blk, x, num_heads: int, window_size: int, rope_tables,
                     dp_keep=None, dp_rate: float = 0.0, attn_chunk=None):
    """JAX's _block_forward_xla (eva_vit.py:269-288) over the block's
    parameters: x (B, H, W, C) -> (B, H, W, C). dp_keep: the two residuals'
    keep masks ((B,), (B,)) of stochastic depth at dp_rate, or None.
    attn_chunk: the attention's softmax core over chunks of that many
    windows (ops/attention.py)."""
    b, h, w, c = x.shape
    ws = window_size
    shortcut = x
    hdn = ln(blk.norm1, x, LN_EPS)
    xw, padded = window_partition(hdn, ws)
    nw = xw.shape[0]
    a = eva_attention(blk.attn, xw.reshape(nw, ws * ws, c), num_heads,
                      rope_tables, attn_chunk=attn_chunk)
    a = window_unpartition(a.reshape(nw, ws, ws, c), ws, padded, (h, w))
    k0, k1 = dp_keep if dp_keep is not None else (None, None)
    x = shortcut + drop_path(a, k0, dp_rate)
    m = blk.mlp
    return x + drop_path(swiglu(ln(blk.norm2, x, LN_EPS), m.w1, m.w2, m.w3,
                                m.ffn_ln, LN_EPS), k1, dp_rate)


def _fill(xw, slow, fast, slow_idx, fast_idx):
    """batch_index_fill out of place (differentiable): slow rows at
    slow_idx and fast rows at fast_idx of a zero (W, n, C)."""
    c = xw.shape[-1]
    out = torch.zeros_like(xw)
    out = out.scatter(1, slow_idx[..., None].expand(-1, -1, c), slow)
    return out.scatter(1, fast_idx[..., None].expand(-1, -1, c), fast)


def compressed_block_model(blk, x, scores, num_heads: int, window_size: int,
                           rope_tables, plan, attn_chunk=None):
    """JAX's toc3d_block_forward (toc3d_vit.py:113-177) over the block's
    parameters, routed by ``plan`` (the forward's CompressPlan): x (B, H,
    W, C), scores (B, H*W) -> (B, H, W, C). The gradient reaches the
    scores through the representative token's weights (merge_tokens over
    the fast tokens' scores). rope_tables: the (cos, sin) pair when the
    block applies RoPE at the selected positions (rope_acc), else None.
    attn_chunk: as full_block_model's."""
    b, h, w, c = x.shape
    ws = window_size
    n = ws * ws
    xw, padded = window_partition(x, ws)
    sw, _ = window_partition(scores.reshape(b, h, w, 1), ws, pad_value=-1e6)
    nw = xw.shape[0]
    xw = xw.reshape(nw, n, c)
    sw = sw.reshape(nw, n)
    k = plan.k
    slow = batch_index_select(xw, plan.slow_idx)
    fast = batch_index_select(xw, plan.fast_idx)
    if plan.has_rep:
        fast_score = torch.gather(sw, 1, plan.fast_idx)
        slow = torch.cat([slow, merge_tokens(fast, fast_score)], dim=1)
    sel_idx = None
    if rope_tables is not None:
        sel_idx = plan.slow_idx
        if plan.has_rep:
            sel_idx = torch.cat([sel_idx, torch.full_like(sel_idx[:, :1], k)],
                                dim=1)
    shortcut = slow
    raw1 = eva_attention(blk.attn, ln(blk.norm1, slow, LN_EPS), num_heads,
                         rope_tables, sel_idx, attn_chunk)
    slow = shortcut + raw1
    m = blk.mlp
    raw2 = swiglu(ln(blk.norm2, slow, LN_EPS), m.w1, m.w2, m.w3, m.ffn_ln,
                  LN_EPS)
    slow = slow + raw2
    if plan.has_rep:
        slow = slow[:, :-1]
        fast = fast + raw1[:, -1:] + raw2[:, -1:]
    out = _fill(xw, slow, fast, plan.slow_idx, plan.fast_idx)
    return window_unpartition(out.reshape(nw, ws, ws, c), ws, padded, (h, w))


def patch_embed_model(conv, x, patch_size: int):
    """The conv path of the patch embedding (eva_vit.py:121-122): x (B, H,
    W, 3) -> (B, H/ps, W/ps, C), weight and bias in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), stride=patch_size)
    return y.permute(0, 2, 3, 1)


def _vjp(fn, inputs, params, needs, g):
    """Recompute ``fn(*inputs)`` with autograd at detached copies of the
    inputs that need a gradient and return the vjp of g: one gradient per
    input, then one per parameter (None where none is needed)."""
    n = len(inputs)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) if need else t.detach()
               for t, need in zip(inputs, needs[:n])]
        want = [t for t, need in zip(ins, needs[:n]) if need] + \
            [p for p, need in zip(params, needs[n:]) if need]
        out = fn(*ins)
        got = iter(torch.autograd.grad(out, want, g, allow_unused=True)
                   if want else ())
    return [next(got) if need else None for need in needs[:n + len(params)]]


class FullBlockFn(torch.autograd.Function):
    """Kernel B with the model path's backward (vit_block.py:964-986); the
    backward's attention runs over chunks of attn_chunk windows when it is
    set (the kernel has no probabilities to chunk)."""

    @staticmethod
    def forward(ctx, x, blk, num_heads, window_size, rope_tables, attn_chunk,
                *params):
        ctx.args = (blk, num_heads, window_size, rope_tables, attn_chunk)
        ctx.params = params
        ctx.save_for_backward(x)
        return fused_full_block(blk, x, num_heads, window_size, rope_tables)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        blk, heads, ws, rope, chunk = ctx.args
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[6:]
        grads = _vjp(lambda xx: full_block_model(
            blk, xx, heads, ws, rope, attn_chunk=chunk), [x], ctx.params,
            needs, g)
        return (grads[0], None, None, None, None, None, *grads[1:])


class CompressedBlockFn(torch.autograd.Function):
    """Kernel C with the model path's backward (vit_block.py:989-1013):
    the gradient reaches the parameters, x and the scores. The forward
    takes the top-k once (compress_plan; training passes align_k False, the
    reference's counts, toc3d_vit.py:223-231) and the backward routes by
    the same plan; its attention is chunked as FullBlockFn's."""

    @staticmethod
    def forward(ctx, x, scores, blk, num_heads, window_size, ratio,
                rope_tables, use_represent, rope_acc, align_k, attn_chunk,
                *params):
        b, h, w, _ = x.shape
        plan = compress_plan(scores, b, h, w, window_size, ratio,
                             use_represent, align_k)
        ctx.args = (blk, num_heads, window_size,
                    rope_tables if rope_acc else None, plan, attn_chunk)
        ctx.params = params
        ctx.save_for_backward(x, scores)
        return fused_compressed_block(blk, x, scores, num_heads, window_size,
                                      ratio, rope_tables, use_represent,
                                      rope_acc, align_k, plan=plan)

    @staticmethod
    def backward(ctx, g):
        x, scores = ctx.saved_tensors
        blk, heads, ws, rope, plan, chunk = ctx.args
        needs = ctx.needs_input_grad[:2] + ctx.needs_input_grad[11:]
        grads = _vjp(lambda xx, ss: compressed_block_model(
            blk, xx, ss, heads, ws, rope, plan, chunk), [x, scores],
            ctx.params, needs, g)
        return (grads[0], grads[1], None, None, None, None, None, None,
                None, None, None, *grads[2:])


class PatchEmbedFn(torch.autograd.Function):
    """Kernel A with the conv path's backward (eva_vit.py:125-143)."""

    @staticmethod
    def forward(ctx, x, conv, patch_size, weight, bias):
        ctx.args = (conv, patch_size)
        ctx.save_for_backward(x)
        wmat, b = pack_patch_weight(conv, x.dtype)
        return patchify_matmul(x, wmat, b, patch_size)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        conv, ps = ctx.args
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[3:]
        grads = _vjp(lambda xx: patch_embed_model(conv, xx, ps), [x],
                     (conv.weight, conv.bias), needs, g)
        return (grads[0], None, None, *grads[1:])


def trainable_full_block(blk, x, num_heads: int, window_size: int,
                         rope_tables, attn_chunk=None):
    """Kernel B, differentiable (FullBlockFn)."""
    return FullBlockFn.apply(x, blk, num_heads, window_size, rope_tables,
                             attn_chunk, *blk.parameters())


def trainable_compressed_block(blk, x, scores, num_heads: int,
                               window_size: int, ratio: float, rope_tables,
                               use_represent: bool, rope_acc: bool,
                               align_k: bool = False, attn_chunk=None):
    """Kernel C, differentiable in the parameters, x and the scores
    (CompressedBlockFn)."""
    return CompressedBlockFn.apply(x, scores, blk, num_heads, window_size,
                                   ratio, rope_tables, use_represent,
                                   rope_acc, align_k, attn_chunk,
                                   *blk.parameters())


def trainable_patch_embed(conv, x, patch_size: int):
    """Kernel A, differentiable in the conv's weight and bias
    (PatchEmbedFn)."""
    return PatchEmbedFn.apply(x, conv, patch_size, conv.weight, conv.bias)
