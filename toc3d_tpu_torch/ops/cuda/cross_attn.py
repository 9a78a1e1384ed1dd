"""Flash attention core of the PETR decoder (kernel D; source
csrc/cross_attn.cu).

Replaces toc3d_tpu/ops/pallas/cross_attn.py :: flash_attention_core (:118):
softmax(q k^T) v per head, q arriving pre-scaled, no mask, f32 logits and
statistics, P rounded to the value dtype before P.V, normalisation deferred.
The q/k/v/out projections stay outside the kernel, as in the JAX package.

On the card the key axis is split across blocks (``flash_splits``): a
partial launch writes each split's unnormalised f32 output, row max and
row sum to scratch, and a combine launch merges the splits.
"""
from __future__ import annotations

import functools
import math

import torch

from . import check_cuda, check_device
from .build import call, stream_of

KEY_TILE = 64       # keys per tile of the partial kernel
QUERY_TILE = 64     # queries per block
H100_SMS = 132


def flash_splits(nq: int, nk: int, heads: int, batch: int = 1,
                 sms: int = H100_SMS):
    """The split rule of the partial kernel: (splits, tiles per split).

    Enough splits that the grid holds about 4 blocks per SM, but no more
    than one per 512 keys, so that each split walks at least a few 64-key
    tiles; then the tiles are dealt out evenly, which leaves no split
    empty: split s covers key tiles [s * per, min((s + 1) * per, tiles))."""
    tiles = math.ceil(nk / KEY_TILE)
    blocks = math.ceil(nq / QUERY_TILE) * heads * batch
    splits = min(math.ceil(nk / 512), math.ceil(4 * sms / max(blocks, 1)))
    splits = max(1, min(splits, tiles))
    per = math.ceil(tiles / splits)
    return math.ceil(tiles / per), per


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_plain(q, k, v, num_heads: int):
    """Plain version with the kernel's rounding points: p = exp(s - max)
    in f32, P.V on P rounded to v.dtype, divided by the f32 row sum."""
    b, nq, c = q.shape
    d = c // num_heads
    dt = v.dtype

    def sh(t):
        return t.reshape(b, -1, num_heads, d).transpose(1, 2)

    s = sh(q).float() @ sh(k).float().transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(dt).float() @ sh(v).float()) / l
    return o.to(dt).transpose(1, 2).reshape(b, nq, c)


@torch.library.custom_op(
    "toc3d::flash_attention_core", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, int num_heads) -> Tensor")
def _flash_op(q, k, v, num_heads):
    return flash_attention_plain(q, k, v, num_heads).contiguous()


@_flash_op.register_fake
def _flash_fake(q, k, v, num_heads):
    return q.new_empty(q.shape, dtype=v.dtype)


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, num_heads):
    """Kernel D's two launches (partial over the key splits, combine);
    counted once in ``launches``. The split count reads the card's SM count
    here, at run time, never at trace time."""
    check_cuda("flash_attention_core", q, k, v, dtype=torch.bfloat16)
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if (d not in (32, 64) or c % num_heads or k.shape != v.shape
            or k.shape[0] != b or k.shape[2] != c or nk == 0):
        raise ValueError(f"flash_attention_core: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} with {num_heads} heads")
    out = torch.empty_like(q)
    if b == 0 or nq == 0:
        return out
    splits, per = flash_splits(nq, nk, num_heads, b, _sms(q.device.index))
    # one scratch buffer: the splits' f32 outputs (splits, B, Q, C), then
    # their row maxima and row sums (splits, B, heads, Q) each
    no, ns = splits * b * nq * c, splits * b * num_heads * nq
    scratch = torch.empty(no + 2 * ns, dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    call("cross_attn", "toc3d_flash_attention", q.data_ptr(), k.data_ptr(),
         v.data_ptr(), base, base + 4 * no, base + 4 * (no + ns),
         out.data_ptr(), b, nq, nk, num_heads, d, splits, per, stream_of(q))
    flash_attention_core.launches += 1
    return out


def flash_attention_core(q, k, v, num_heads: int):
    """q: (B, Q, C) already scaled by d^-0.5; k, v: (B, K, C). Returns
    (B, Q, C) in v.dtype, through the op ``toc3d::flash_attention_core``:
    kernel D on the card, the plain version on the CPU."""
    check_device("flash_attention_core", q)
    return torch.ops.toc3d.flash_attention_core(q, k, v, num_heads)


flash_attention_core.launches = 0


def attention_core_model(q, k, v, num_heads: int):
    """The model path of the attention core (cross_attn.py:167-177,
    _xla_core): f32 logits of the pre-scaled q against k, softmax, the
    weights in v.dtype, times v. Differentiable; the backward of
    ``FlashAttentionFn``."""
    b, nq, c = q.shape
    d = c // num_heads

    def sh(t):
        return t.reshape(b, -1, num_heads, d).transpose(1, 2)

    logits = sh(q).float() @ sh(k).float().transpose(-1, -2)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = w @ sh(v)
    return o.transpose(1, 2).reshape(b, nq, c)


class FlashAttentionFn(torch.autograd.Function):
    """Trainable kernel D (cross_attn.py:180-203, flash_attention): the
    forward is ``flash_attention_core`` (the kernel on the card, its plain
    version on the CPU) and saves only q, k, v; the backward recomputes
    ``attention_core_model`` at them with autograd and returns its vjp."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return flash_attention_core(q.contiguous(), k.contiguous(),
                                    v.contiguous(), num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_core_model(*ins, ctx.num_heads)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None)


def flash_attention(q, k, v, num_heads: int):
    """Differentiable kernel D: q (B, Q, C) pre-scaled, k, v (B, K, C)."""
    return FlashAttentionFn.apply(q, k, v, num_heads)
