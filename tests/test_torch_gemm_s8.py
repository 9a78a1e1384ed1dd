"""Kernel G8, the int8 TMA + wgmma GEMM behind B8 and C8
(toc3d_tpu_torch/csrc/gemm_sm90.cuh, int8 form; wrapper
ops/cuda/int8.gemm_s8_sm90), rehearsed on the CPU: the kernel cannot run
here, so its index arithmetic is restated in torch and its plain version,
``gemm_s8_plain``, is held to JAX's _qmm bit for bit.

* the persistent tile walk (``tile += gridDim.x`` over row-major tiles, the
  tile sizes read from the header) covers every (m, n) tile of each of the
  four main-path GEMMs at each of the main path's row counts exactly once;
* an s8 stage is one 128-byte swizzle row of K, as a bf16 stage is, so the
  ring, the boxes and the 32-byte k steps of kernel G carry over;
* the K tail that TMA zero-fills (boxes of 128 int8 along K) adds nothing:
  tile by tile the int64 sums of the padded boxes equal the exact product;
* no int32 sum can overflow at the largest main-path K (127^2 * 2736 <
  2^31), checked on the extreme operands in int32 arithmetic;
* wgmma's m64n256k32 s32 fragment, as the epilogue reads it, covers the
  64 x 256 tile once and keeps each gate pair (w1 row j, w2 row j) in one
  thread's register pair;
* ``gemm_s8_plain`` with the f32, residual, gate and bf16 epilogues equals
  JAX's ``_qmm`` (toc3d_tpu/ops/pallas/vit_block.py:277) plus the f32 bias,
  then the same epilogue in jnp, bit for bit, on the quantization of
  ``_rowquant`` (:247, dynamic) and ``_statquant`` (:259, static) of the
  same numpy-seeded inputs;
* ``gemm_s8_sm90`` on CPU tensors is the plain version and counts no
  launch.

tests/test_torch_cuda.py holds the kernel itself to the mma.sync tile
(``gemm_s8``) and to ``gemm_s8_plain`` on the card.
"""
import os
import re
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.ops.pallas.vit_block import _qmm, _rowquant, _statquant

# kernel G's tile walk and wgmma fragment, which G8 shares (the same body)
from test_torch_gemm import _HEADER, GEMMS, ROWS, SMS, _fragment, _tile_walk

from toc3d_tpu_torch.ops.cuda import int8

# kernel G8's tile: BM x BN outputs, K in steps of BK_S8 int8 (kernel G's
# bf16 K step BK beside it: the same 128 bytes)
BM, BN, BK, BK_S8 = (int(re.search(rf"constexpr int {name} = (\d+);",
                                   _HEADER).group(1))
                     for name in ("BM", "BN", "BK", "BK_S8"))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("gemm", sorted(GEMMS))
def test_tile_walk_covers_each_tile_once(gemm, m):
    n = GEMMS[gemm][0]
    walk = _tile_walk(m, n, SMS)
    tiles = [t for block in walk for t in block]
    want = [(m0, n0) for m0 in range(0, m, BM) for n0 in range(0, n, BN)]
    assert len(walk) == min(len(want), SMS)
    assert sorted(tiles) == want
    shares = [len(block) for block in walk]
    assert max(shares) - min(shares) <= 1
    assert all(block == sorted(block) for block in walk)


def test_s8_stage_is_one_swizzle_row_like_bf16():
    """A K tile of 128 int8 is 128 bytes, as 64 bf16 are: the stage bytes
    (A_BYTES, STAGE_BYTES), the TMA boxes and the four 32-byte k steps of a
    stage (k16 bf16, k32 int8) are the same for both operand types."""
    assert BK_S8 * 1 == BK * 2 == 128
    assert BK_S8 // 32 == BK // 16 == 4
    assert re.search(r"constexpr int A_BYTES = BM \* BK \* 2;", _HEADER)
    assert "m64n256k32.s32.s8.s8" in _HEADER
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in _HEADER


def _padded_tile_sum(a, w, m0, n0):
    """One output tile as G8 forms it: boxes of BM rows of a and BN rows of
    w, BK_S8 columns at a time, zero past M, N and K, the int64 sums of the
    K tiles added in order."""
    m, k = a.shape
    n = w.shape[0]
    kt = -(-k // BK_S8)
    ap = torch.zeros(BM, kt * BK_S8, dtype=torch.int64)
    wp = torch.zeros(BN, kt * BK_S8, dtype=torch.int64)
    ap[:min(BM, m - m0), :k] = a[m0:m0 + BM]
    wp[:min(BN, n - n0), :k] = w[n0:n0 + BN]
    acc = torch.zeros(BM, BN, dtype=torch.int64)
    for t in range(kt):
        s = slice(t * BK_S8, (t + 1) * BK_S8)
        acc += ap[:, s] @ wp[:, s].t()
    return acc


@pytest.mark.parametrize("m,n,k", [(1, 136, 48), (129, 300, 176),
                                   (200, 272, 2736), (130, 264, 1024),
                                   (257, 512, 1040)])
def test_zero_filled_k_tail_is_exact(m, n, k):
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int64))
    w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int64))
    exact = a @ w.t()
    for block in _tile_walk(m, n, SMS):
        for m0, n0 in block:
            tile = _padded_tile_sum(a, w, m0, n0)
            rows, cols = min(BM, m - m0), min(BN, n - n0)
            assert torch.equal(tile[:rows, :cols],
                               exact[m0:m0 + rows, n0:n0 + cols])
            assert not tile[rows:].any() and not tile[:, cols:].any()


def test_s32_sums_cannot_overflow_at_the_largest_k():
    """Quantized values lie in [-127, 127] (never -128), so an s32 sum over
    K is at most 127^2 * K in magnitude; at the main path's largest K (w3,
    2736) that is 44,129,424 < 2^31. The extreme operands, summed in int32
    by numpy (which wraps on overflow), give the exact int64 sums."""
    kmax = max(k for _, k in GEMMS.values())
    assert kmax == 2736 and 127 * 127 * kmax < 2 ** 31 - 1
    a = np.array([[127] * kmax, [-127] * kmax], np.int32)
    w = np.array([[127] * kmax, [-127] * kmax, [127, -127] * (kmax // 2)],
                 np.int32)
    got = a @ w.T
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, a.astype(np.int64) @ w.T.astype(
        np.int64))
    assert got.max() == 127 * 127 * kmax and got.min() == -127 * 127 * kmax


def test_s32_fragment_covers_tile_and_keeps_gate_pairs():
    """wgmma's D fragment is laid out alike for s32 and f32 accumulators
    (the PTX ISA), so stage_chunk reads the m64n256k32 s32 fragment as G's
    f32 one: each (row, column) of the 64 x BN tile once, gate pairs in one
    thread's register pair."""
    owner = {}
    for thread in range(128):
        for reg in range(BN // 2):
            rc = _fragment(thread, reg)
            assert rc not in owner
            owner[rc] = (thread, reg)
    assert len(owner) == 64 * BN
    for (row, col), (thread, reg) in owner.items():
        if col % 2 == 0:
            assert owner[(row, col + 1)] == (thread, reg + 1)
            assert reg % 2 == 0


def _quantized(rows, k, n, static, seed):
    """numpy-seeded activations quantized by JAX (_rowquant or _statquant),
    int8 weights (K, N), channel scales, bias and a bf16 residual."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, k) * np.logspace(-2, 1, rows)[:, None]).astype(
        np.float32)
    if static:
        st = np.float32(np.abs(x).max() / 127 / 2)    # saturates the tails
        xq, xs = _statquant(jnp.asarray(x), jnp.full((1, 1), st))
    else:
        xq, xs = _rowquant(jnp.asarray(x))
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    # channel scales that keep the dequantized sums within a few units, as
    # in a block (the silu of inputs below about -85 underflows differently
    # in XLA's and PyTorch's CPU kernels; the card follows neither)
    ws = (rng.rand(n) * 2e-4 + 1e-5).astype(np.float32)
    b = (rng.randn(n) * 0.5).astype(np.float32)
    res = jnp.asarray(rng.randn(rows, n // 2 * 2).astype(np.float32)).astype(
        jnp.bfloat16)
    return xq, xs, w, ws, b, res


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("epi", ["f32", "res", "gate", "bf16"])
def test_plain_equals_jax_qmm(epi, static):
    """gemm_s8_plain against _qmm + bias and the block's epilogue in jnp
    (vit_block.py _attention :107-111 and :148-151, _swiglu :160-170): f32
    out, the residual add in bf16, the SwiGLU gate on the interleaved (w1,
    w2) columns, and the plain bf16 cast; bit for bit."""
    rows, k, n = 37, 176, 96
    bf = jnp.bfloat16
    xq, xs, w, ws, b, res = _quantized(rows, k, n, static, 11)
    acc = _qmm(xq, xs, jnp.asarray(w), jnp.asarray(ws)) + jnp.asarray(b)
    if epi == "f32":
        ref = acc
    elif epi == "res":
        ref = res + acc.astype(bf)
    elif epi == "gate":
        x1 = acc[:, 0::2].astype(bf).astype(jnp.float32)
        ref = (x1 * jax.nn.sigmoid(x1)).astype(bf) * acc[:, 1::2].astype(bf)
    else:
        ref = acc.astype(bf)
    aq = torch.from_numpy(np.array(xq))
    sc = torch.from_numpy(np.array(xs)).reshape(-1)
    assert sc.numel() == (1 if static else rows)
    out = int8.gemm_s8_plain(
        aq, sc, torch.from_numpy(w.T.copy()), torch.from_numpy(ws),
        torch.from_numpy(b),
        res=torch.from_numpy(_f32(res)).to(torch.bfloat16)
        if epi == "res" else None,
        out_f32=epi == "f32", gate=epi == "gate")
    assert out.dtype == (torch.float32 if epi == "f32" else torch.bfloat16)
    assert out.shape == ((rows, n // 2) if epi == "gate" else (rows, n))
    np.testing.assert_array_equal(_f32(out), _f32(ref))


def test_gemm_s8_sm90_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(5)
    m, k, n = 9, 48, 40
    aq = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    xs = torch.from_numpy((rng.rand(m) * 1e-2).astype(np.float32))
    ws = torch.from_numpy((rng.rand(n) * 1e-2).astype(np.float32))
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(
        torch.bfloat16)
    before = int8.gemm_s8_sm90.launches
    for scales in (xs, xs[:1]):
        for kw in ({"out_f32": True}, {}, {"res": res}, {"gate": True}):
            assert torch.equal(
                int8.gemm_s8_sm90(aq, scales, wq, ws, bias, **kw),
                int8.gemm_s8_plain(aq, scales, wq, ws, bias, **kw))
    assert int8.gemm_s8_sm90.launches == before
