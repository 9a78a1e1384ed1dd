"""Kernel G, the bf16 TMA + wgmma GEMM behind kernels B and C
(toc3d_tpu_torch/csrc/gemm_sm90.cuh, wrapper ops/cuda/vit_block.gemm_bf16),
rehearsed on the CPU: the kernel cannot run here, so its index arithmetic is
restated in torch and its plain version is held to the block composition and
to JAX.

* the persistent tile walk (the kernel's ``tile += gridDim.x`` over
  row-major tiles, with the tile sizes read from the header) covers every
  (m, n) tile of each main-path GEMM exactly once, with the blocks' shares
  within one tile;
* the K tail that TMA zero-fills (boxes of 64 along K, 128 rows of A and
  256 rows of W) adds nothing: tile by tile the padded sums equal the exact
  product (integer-valued operands, so every f32 sum is exact);
* wgmma's m64n256 accumulator fragment, as the epilogue reads it, covers
  the 64 x 256 tile once and puts each interleaved gate pair (w1 row j, w2
  row j) in one thread's register pair;
* ``gemm_bf16_plain``, for every epilogue, equals the products and
  roundings that ``full_block_plain`` and ``compressed_block_plain``
  compose (bit for bit, bf16);
* the plain GEMM with the SwiGLU gate, then the sub-LN and the w3 GEMM,
  equals JAX's ``_swiglu`` (toc3d_tpu/ops/pallas/vit_block.py:154) on the
  same numpy-seeded inputs in f32, within 2e-5 (f32 sums in another order).

tests/test_torch_cuda.py holds the kernel itself to ``gemm_bf16_plain`` on
the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from toc3d_tpu.ops.pallas.vit_block import _swiglu as jax_swiglu

from toc3d_tpu_torch.layers import layer_norm
from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
from toc3d_tpu_torch.ops.cuda import vit_block as vb

BF = torch.bfloat16
SMS = 132   # H100 SXM

# kernel G's tile: BM x BN outputs, K in steps of BK
_HEADER = (Path(vb.__file__).resolve().parents[2] / "csrc"
           / "gemm_sm90.cuh").read_text()
BM, BN, BK = (int(re.search(rf"constexpr int {name} = (\d+);",
                            _HEADER).group(1))
              for name in ("BM", "BN", "BK"))

# (N, K) of the four GEMMs of a ViT-L block (hp = round_up(2730, 16))
GEMMS = {"qkv": (3072, 1024), "o": (1024, 1024), "gate": (5472, 1024),
         "w3": (1024, 2736)}
# their row counts on the main path: B's 30256 / 30400 at ws 16 / 20 (the
# LN(0) rows of the windows' out-of-image places, for the QKV GEMM; 30000 for
# the rest), C's nw * kr at ws 16 / 20 and ratio .5 / .4 / .3
ROWS = (30256, 30400, 30000, 21504, 18090, 17304, 14490, 12936, 10890)


def _tile_walk(m, n, sms):
    """Kernel G's persistent walk for an (m, n) output on ``sms`` SMs:
    min(tiles, sms) blocks, block b taking tiles b, b + grid, ... in
    row-major order (n fastest). Returns, per block, its (m0, n0) tile
    origins in the order it computes them."""
    tiles_n = -(-n // BN)
    tiles = -(-m // BM) * tiles_n
    grid = min(tiles, sms)
    return [[(t // tiles_n * BM, t % tiles_n * BN)
             for t in range(b, tiles, grid)] for b in range(grid)]


@pytest.mark.parametrize("gemm", sorted(GEMMS))
def test_tile_walk_covers_each_tile_once(gemm):
    n = GEMMS[gemm][0]
    for m in ROWS:
        walk = _tile_walk(m, n, SMS)
        tiles = [t for block in walk for t in block]
        want = [(m0, n0) for m0 in range(0, m, BM)
                for n0 in range(0, n, BN)]
        assert len(walk) == min(len(want), SMS)
        assert sorted(tiles) == want
        shares = [len(block) for block in walk]
        assert max(shares) - min(shares) <= 1
        # each block walks its tiles row-major (n fastest), as the producer
        # and both consumer warpgroups do
        assert all(block == sorted(block) for block in walk)


def _padded_tile_product(a, w, m0, n0):
    """One output tile as the kernel forms it: boxes of BM rows of a and
    BN rows of w, BK columns at a time, zero past M, N and K, summed over
    the K tiles in order in f32."""
    m, k = a.shape
    n = w.shape[0]
    kt = -(-k // BK)
    ap = torch.zeros(BM, kt * BK)
    wp = torch.zeros(BN, kt * BK)
    ap[:min(BM, m - m0), :k] = a[m0:m0 + BM]
    wp[:min(BN, n - n0), :k] = w[n0:n0 + BN]
    acc = torch.zeros(BM, BN)
    for t in range(kt):
        s = slice(t * BK, (t + 1) * BK)
        acc += ap[:, s] @ wp[:, s].t()
    return acc


@pytest.mark.parametrize("m,n,k", [(1, 136, 48), (129, 300, 176),
                                   (200, 272, 2736), (130, 264, 1000)])
def test_zero_filled_k_tail_is_exact(m, n, k):
    rng = np.random.RandomState(0)
    # integers in [-3, 3]: every partial sum is an exact f32 integer
    a = torch.from_numpy(rng.randint(-3, 4, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.randint(-3, 4, (n, k)).astype(np.float32))
    exact = a.double() @ w.double().t()
    for block in _tile_walk(m, n, SMS):
        for m0, n0 in block:
            tile = _padded_tile_product(a, w, m0, n0)
            rows, cols = min(BM, m - m0), min(BN, n - n0)
            assert torch.equal(tile[:rows, :cols].double(),
                               exact[m0:m0 + rows, n0:n0 + cols])
            # the clipped part is zero: nothing leaks from the pads
            assert not tile[rows:].any() and not tile[:, cols:].any()


def _fragment(thread, reg):
    """(row, column) of accumulator register ``reg`` of ``thread`` (0-127)
    in wgmma's m64nBN f32 fragment, as stage_chunk reads it: register 4j + e
    holds row 16 * warp + g (+ 8 for e >= 2), column 8j + 2t + (e & 1),
    g = lane / 4, t = lane % 4 (the PTX ISA's wgmma D fragment layout)."""
    warp, lane = divmod(thread, 32)
    g, t = divmod(lane, 4)
    j, e = divmod(reg, 4)
    return 16 * warp + g + 8 * (e >= 2), 8 * j + 2 * t + (e & 1)


def test_wgmma_fragment_covers_tile_and_keeps_gate_pairs():
    owner = {}
    for thread in range(128):
        for reg in range(BN // 2):
            rc = _fragment(thread, reg)
            assert rc not in owner
            owner[rc] = (thread, reg)
    assert len(owner) == 64 * BN
    for (row, col), (thread, reg) in owner.items():
        if col % 2 == 0:
            # the gate pair (2j, 2j + 1): one thread, registers (r, r + 1)
            assert owner[(row, col + 1)] == (thread, reg + 1)
            assert reg % 2 == 0


def _block(c, heads, hidden, seed):
    blk = Block(EVAViTConfig(embed_dim=c, num_heads=heads,
                             mlp_ratio=hidden / c))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.05 if p.dim() > 1 else 0.3))
    return blk


def test_gate_pairs_are_interleaved_w1_w2_rows():
    blk = _block(64, 2, 170, 1)
    wts = vb.pack_block_weights(blk, 2, BF)
    hp = wts.w3.shape[1]
    assert hp == 176 and wts.w12.shape == (2 * hp, 64)
    assert torch.equal(wts.w12[0:340:2], blk.mlp.w1.weight.to(BF))
    assert torch.equal(wts.w12[1:340:2], blk.mlp.w2.weight.to(BF))
    assert not wts.w12[340:].any() and not wts.b12[340:].any()


def _inputs(rows, c, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, c, generator=g) * 0.7).to(BF)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("epi", ["qkv_f32", "o_bias", "o_res", "gate",
                                 "w3_res"])
def test_plain_epilogues_equal_the_block_composition(epi, dtype):
    """gemm_bf16_plain against the products and roundings of
    _attention_plain / _swiglu_plain / _add (vit_block.py), bit for bit."""
    c, heads, hidden, rows = 64, 2, 170, 37
    wts = vb.pack_block_weights(_block(c, heads, hidden, 2), heads, dtype)
    x = _inputs(rows, c, 3).to(dtype)
    h = _inputs(rows, c, 4).to(dtype)
    if epi == "qkv_f32":
        out = vb.gemm_bf16_plain(h, wts.wqkv, wts.bqkv, out_f32=True)
        ref = vb._mm(wts, h, "qkv")
    elif epi == "o_bias":
        out = vb.gemm_bf16_plain(h, wts.wo, wts.bo)
        ref = vb._mm(wts, h, "o").to(dtype)
    elif epi == "o_res":
        out = vb.gemm_bf16_plain(h, wts.wo, wts.bo, res=x)
        ref = vb._add(x, vb._mm(wts, h, "o").to(dtype))
    elif epi == "gate":
        out = vb.gemm_bf16_plain(h, wts.w12, wts.b12, gate=True)
        acc = vb._mm(wts, h, "w12")
        a = acc[:, 0::2][:, :hidden].to(dtype)
        b = acc[:, 1::2][:, :hidden].to(dtype)
        ref = (F.silu(a.float()).to(dtype).float() * b.float()).to(dtype)
        assert out.shape == (rows, wts.w3.shape[1])
        assert not out[:, hidden:].any()
        out = out[:, :hidden]
    else:
        g = torch.zeros(rows, wts.w3.shape[1], dtype=dtype)
        g[:, :hidden] = _inputs(rows, hidden, 5).to(dtype)
        out = vb.gemm_bf16_plain(g, wts.w3, wts.b3, res=x)
        ref = vb._add(x, vb._mm(wts, g, "w3").to(dtype))
    assert out.dtype == ref.dtype
    assert torch.equal(out, ref)


def test_gemm_bf16_on_cpu_is_the_plain_version():
    wts = vb.pack_block_weights(_block(64, 2, 170, 6), 2, BF)
    h = _inputs(9, 64, 7)
    before = vb._gemm.launches
    for kw in ({"out_f32": True}, {}, {"res": _inputs(9, 64, 8)}):
        assert torch.equal(vb.gemm_bf16(h, wts.wo, wts.bo, **kw),
                           vb.gemm_bf16_plain(h, wts.wo, wts.bo, **kw))
    assert torch.equal(vb.gemm_bf16(h, wts.w12, wts.b12, gate=True),
                       vb.gemm_bf16_plain(h, wts.w12, wts.b12, gate=True))
    assert vb._gemm.launches == before


@pytest.mark.parametrize("rows,hidden", [(5, 40), (37, 48), (64, 170)])
def test_gate_gemm_matches_jax_swiglu(rows, hidden):
    """f32: the gate GEMM (interleaved, zero-padded to hp columns), the
    sub-LN over the hidden columns and the w3 GEMM, against JAX's
    _swiglu."""
    c = 64
    rng = np.random.RandomState(rows)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x = f(rows, c)
    w1, w2, w3 = f(c, hidden) * 0.1, f(c, hidden) * 0.1, f(hidden, c) * 0.1
    b1, b2, b3 = f(hidden) * 0.1, f(hidden) * 0.1, f(c) * 0.1
    fls, flb = 1 + f(hidden) * 0.1, f(hidden) * 0.1
    ref = jax_swiglu(jnp.asarray(x), {
        "w1": jnp.asarray(w1), "w2": jnp.asarray(w2), "b1": jnp.asarray(b1),
        "b2": jnp.asarray(b2), "fls": jnp.asarray(fls),
        "flb": jnp.asarray(flb), "w3": jnp.asarray(w3),
        "b3": jnp.asarray(b3)})
    hp = -(-hidden // 16) * 16
    w12 = torch.zeros(2 * hp, c)
    w12[0:2 * hidden:2] = torch.from_numpy(w1.T)
    w12[1:2 * hidden:2] = torch.from_numpy(w2.T)
    b12 = torch.zeros(2 * hp)
    b12[0:2 * hidden:2] = torch.from_numpy(b1)
    b12[1:2 * hidden:2] = torch.from_numpy(b2)
    g = vb.gemm_bf16_plain(torch.from_numpy(x), w12, b12, gate=True)
    assert g.shape == (rows, hp) and not g[:, hidden:].any()
    g = layer_norm(g[:, :hidden], torch.from_numpy(fls),
                   torch.from_numpy(flb), 1e-6)
    w3p = torch.zeros(c, hp)
    w3p[:, :hidden] = torch.from_numpy(w3.T)
    gp = torch.zeros(rows, hp)
    gp[:, :hidden] = g
    out = vb.gemm_bf16_plain(gp, w3p, torch.from_numpy(b3))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
