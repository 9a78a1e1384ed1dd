"""The split-K plan of the port's flash kernel (kernel D) and its online
softmax, rehearsed on the CPU.

The CUDA kernels run only on a card. Their arithmetic is restated here in
torch: each key split walks its 64-key tiles with a running max m, a running
sum l and an unnormalised output o, p = 2^(s log2e - m log2e) (the ex2 form
of csrc/cross_attn.cu online_softmax_tile), P rounded to v.dtype before P.V;
the combine step merges the splits as out = sum_s e^(m_s - m) o_s / sum_s
e^(m_s - m) l_s. In f32 the restatement must match the plain version and
the JAX Pallas kernel (interpret mode, as tests/test_flash_attn.py runs it)
within 2e-5. In bf16 it must stay inside kernel D's bound on the card (2^-5
of the plain version's max, 2^-6 of its mean).
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from toc3d_tpu.ops.pallas.cross_attn import flash_attention_core as jax_flash
from toc3d_tpu_torch.ops.cuda.cross_attn import (KEY_TILE, QUERY_TILE,
                                                 flash_attention_plain,
                                                 flash_splits)

LOG2E = 1.4426950408889634


def split_ranges(nk, splits, per):
    """The [start, end) key range of each split, as flash_partial_kernel
    takes it: split s covers key tiles [s * per, min((s + 1) * per,
    tiles))."""
    step = per * KEY_TILE
    return [(s * step, min((s + 1) * step, nk)) for s in range(splits)]


@pytest.mark.parametrize("nq", [1, 900])
@pytest.mark.parametrize("nk", [1, 63, 64, 65, 1668, 30000])
def test_split_rule_covers_every_key_once(nq, nk):
    splits, per = flash_splits(nq, nk, 8)
    ranges = split_ranges(nk, splits, per)
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                      # contiguous, no overlap
    for a0, a1 in ranges:
        assert a0 < a1                       # no split is empty
        assert a0 % KEY_TILE == 0            # whole tiles but the last
    for a0, a1 in ranges[:-1]:
        assert (a1 - a0) % KEY_TILE == 0


def test_split_rule_fills_the_h100_at_the_main_path_shapes():
    """Cross-attention (900 queries, 30000 keys, 8 heads): at least 4 x
    132 blocks; self-attention (1668 keys): several splits of several tiles
    each."""
    splits, per = flash_splits(900, 30000, 8)
    assert math.ceil(900 / QUERY_TILE) * 8 * splits >= 4 * 132
    assert (splits, per) == (5, 94)
    splits, per = flash_splits(900, 1668, 8)
    assert splits > 1 and per >= 4


def _online(qh, kh, vh, ranges):
    """Per key range: (m, l, o) of the flash kernel's online softmax over
    64-key tiles, logits and statistics in f32, P rounded to v's dtype."""
    parts = []
    for s0, s1 in ranges:
        m = torch.full(qh.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(qh.shape[:-1] + (vh.shape[-1],))
        for t0 in range(s0, s1, KEY_TILE):
            t1 = min(t0 + KEY_TILE, s1)
            s = qh.float() @ kh[..., t0:t1, :].float().transpose(-1, -2)
            mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m * LOG2E - mn * LOG2E)
            p = torch.exp2(s * LOG2E - mn * LOG2E)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            o = alpha * o + p.to(vh.dtype).float() @ vh[..., t0:t1, :].float()
            m = mn
        parts.append((m, l, o))
    return parts


def _combine(parts):
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    w = [torch.exp(p[0] - m) for p in parts]
    num = sum(wi * p[2] for wi, p in zip(w, parts))
    den = sum(wi * p[1] for wi, p in zip(w, parts))
    return num / den


def _splitk(q, k, v, heads):
    """The partial and combine launches of kernel D, restated."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    splits, per = flash_splits(nq, nk, heads, b)

    def sh(t):
        return t.reshape(b, -1, heads, d).transpose(1, 2)

    out = _combine(_online(sh(q), sh(k), sh(v), split_ranges(nk, splits, per)))
    return out.to(v.dtype).transpose(1, 2).reshape(b, nq, c), splits


@pytest.mark.parametrize("b,q,kv,c,h,want_splits", [
    (1, 70, 1668, 64, 2, 4),
    (2, 37, 600, 64, 2, 2),
    (1, 24, 65, 64, 2, 1),        # one split, ragged second tile
    (1, 900, 3000, 256, 8, 5),    # the decoder's shape class
])
def test_splitk_arithmetic_matches_plain_and_pallas(b, q, kv, c, h,
                                                   want_splits):
    rng = np.random.RandomState(0)
    qa = rng.randn(b, q, c).astype(np.float32) * 0.2 * (c // h) ** -0.5
    ka = rng.randn(b, kv, c).astype(np.float32) * 0.2
    va = rng.randn(b, kv, c).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (qa, ka, va))
    out, splits = _splitk(tq, tk, tv, h)
    assert splits == want_splits
    plain = flash_attention_plain(tq, tk, tv, h)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0,
                               atol=2e-5)
    ref = jax_flash(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va), h,
                    interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("b,q,kv,c,h", [
    (1, 900, 1668, 256, 8),       # the decoder's self-attention: 4 splits
    (1, 120, 6000, 256, 8),       # 12 splits of 8 tiles
])
def test_splitk_in_bf16_inside_the_kernel_bound(b, q, kv, c, h):
    """In bf16 the split kernel rounds P at each split's running max, where
    the plain version rounds exp(s - max) at the row's max. The difference
    stays inside the bound chip_smoke.py holds kernel D to on the card
    (2^-5 of the plain version's max, 2^-6 of its mean)."""
    g = torch.Generator().manual_seed(kv)
    bf = torch.bfloat16
    tq = (torch.randn(b, q, c, generator=g) * 3 * (c // h) ** -0.5).to(bf)
    tk = torch.randn(b, kv, c, generator=g).to(bf)
    tv = torch.randn(b, kv, c, generator=g).to(bf)
    out, splits = _splitk(tq, tk, tv, h)
    assert splits > 1
    ref = flash_attention_plain(tq, tk, tv, h).float()
    err = (out.float() - ref).abs()
    assert err.max().item() <= 2.0 ** -5 * ref.abs().max().item()
    assert err.mean().item() <= 2.0 ** -6 * ref.abs().mean().item()
