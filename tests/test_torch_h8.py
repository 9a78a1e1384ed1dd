"""Kernel H8, the head decoder's int8 linear in one launch
(toc3d_tpu_torch/csrc/int8_linear.cu; wrapper ops/cuda/int8.int8_linear,
plan ops/cuda/int8.h8_plan), rehearsed on the CPU: the kernel cannot run
here, so its tile plan and its shared-memory layouts are restated in numpy
and its plain version, ``int8_linear_plain``, is held to JAX's
``linear`` on an int8 pack (toc3d_tpu/layers.py:81-121).

* the plan at the five main-path shapes of ToC3D_faster_1600's decoder
  (S1 (900, 256) -> 256, S2 (1668, 256) -> 256, S3 (30000, 256) -> 256,
  S4 (900, 256) -> 2048, S5 (900, 2048) -> 256), at 800x320's image tokens,
  at ``tiny``'s widths (C 64, FFN 128) and at the card tests' shapes: the
  persistent walk (block b takes tiles b, b + grid, ...) covers every (row,
  column) of the output once; a block whose weight tile is resident has one
  column tile; the shared memory and the barriers fit;
* the quantizer's thread map reads every x element of a tile once from the
  TMA boxes and writes every int8 of a k block once, at the address where
  the wgmma descriptor (start address, leading and stride byte offsets,
  128-byte swizzle applied to address bits) reads it; the emulated product
  over those bytes, the weight stages read as the two consumers' halves,
  equals the exact int8 product;
* no s32 sum overflows at K 2048;
* ``int8_linear_plain`` equals JAX's ``linear`` on narrow versions of S1-S5
  bit for bit in bf16 (tolerance 0: the int8 sums are exact on both sides
  and every later step is one f32 product or a bf16 rounding);
* the widths the kernel does not take raise ValueError; on CPU tensors the
  wrapper is the plain version and counts no launch.

tests/test_torch_cuda.py holds the kernel itself to ``int8_linear_plain``
and to row quantization + the mma.sync tile on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from toc3d_tpu.layers import linear as jax_linear
from toc3d_tpu.layers import quantize_linear as jax_quantize_linear

from toc3d_tpu_torch.layers import quantize_linear
from toc3d_tpu_torch.ops.cuda import int8

SMS = 132   # H100 SXM

_SOURCE = (Path(int8.__file__).resolve().parents[2] / "csrc"
           / "int8_linear.cu").read_text()
_GEMM90 = (Path(int8.__file__).resolve().parents[2] / "csrc"
           / "gemm_sm90.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


BM, KB, THREADS = _const("BM"), _const("KB"), _const("THREADS")

# (rows, in, out): the five main-path shapes, the cross-attention's key
# projection at 800x320 (6 x 20 x 50 tokens), tiny's (32 queries, 56 self
# keys, C 64, FFN 128) and the card tests'
MAIN = {"S1": (900, 256, 256), "S2": (1668, 256, 256),
        "S3": (30000, 256, 256), "S4": (900, 256, 2048),
        "S5": (900, 2048, 256)}
SHAPES = dict(MAIN, s800=(6000, 256, 256), tiny_q=(32, 64, 64),
              tiny_kv=(56, 64, 64), tiny_ffn_in=(32, 64, 128),
              tiny_ffn_out=(32, 128, 64), card_1=(1, 64, 96),
              card_37=(74, 64, 96), card_300=(300, 256, 96),
              ragged=(130, 400, 24))


def test_constants_match_the_kernel():
    assert (BM, KB, THREADS) == (int8.H8_BM, int8.H8_KB, 512)
    assert _const("K_MAX") == int8.H8_K_MAX
    assert _const("SMEM_MAX") == int8.H8_SMEM_MAX
    assert _const("MAX_BARS") == int8.H8_MAX_BARS
    assert re.search(r"X_BYTES = BM \* KB \* 2;", _SOURCE)
    for n in (64, 128, 256):   # a consumer's half of BN 128 or 256; G8
        assert f"m64n{n}k32.s32.s8.s8" in _GEMM90


def _walk(plan):
    """Each block's (m0, n0) tiles, as the kernel walks them."""
    return [[(t // plan.tiles_n * BM, t % plan.tiles_n * plan.bn)
             for t in range(b, plan.tiles, plan.grid)]
            for b in range(plan.grid)]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_each_output_once(name):
    m, k, n = SHAPES[name]
    plan = int8.h8_plan(m, n, k, SMS)
    cover = np.zeros((m, n), np.int32)
    for block in _walk(plan):
        assert block, "a block with no tile"
        for m0, n0 in block:
            cover[m0:m0 + BM, n0:n0 + plan.bn] += 1
        if plan.resident:
            assert len({n0 for _, n0 in block}) == 1
    assert (cover == 1).all()
    assert plan.grid <= SMS and plan.smem <= int8.H8_SMEM_MAX
    assert int8.h8_bars(plan.nas, plan.nxb, plan.wst) <= int8.H8_MAX_BARS
    assert plan.panel == (k <= 2 * KB)
    assert plan.nxb >= 2 or plan.nxb == plan.nkb == 1
    assert plan.nas >= min(plan.nkb, 2) and plan.wst >= min(plan.nkb, 2)
    if plan.panel:   # every k block of a tile in its slot
        assert plan.nas >= plan.nkb
    assert plan.smem == int8.h8_smem(plan.bn, plan.nas, plan.nxb, plan.wst)


def test_main_path_plans():
    """The grids of the five shapes: one wave of 64-row tiles where the
    shape allows (S1, S2, S4, S5), the persistent grid at S3 with its weight
    tile resident, the slots of two tiles and x buffers for three; S5
    streams x twice through a ring of slots and weight stages."""
    plans = {s: int8.h8_plan(m, n, k, SMS) for s, (m, k, n) in MAIN.items()}
    assert [(p.bn, p.grid, p.tiles) for p in plans.values()] == [
        (128, 30, 30), (128, 54, 54), (256, 132, 469), (256, 120, 120),
        (128, 30, 30)]
    assert all(p.resident for s, p in plans.items() if s != "S5")
    assert (plans["S3"].nas, plans["S3"].nxb) == (4, 5)
    assert not plans["S5"].panel and plans["S5"].nas < plans["S5"].nkb
    assert plans["S5"].wst >= 4


def _tma_sw128(mat, row0, col0, box_cols, box_rows):
    """The bytes a 128-byte swizzled TMA box of ``mat`` (elements of
    mat.itemsize bytes, box_cols * itemsize == 128) lands as in shared
    memory: row r at 128 r, its 16-byte unit u at unit u ^ (r % 8); zero
    past the matrix."""
    es = mat.itemsize
    assert box_cols * es == 128
    box = np.zeros((box_rows, box_cols), mat.dtype)
    part = mat[row0:row0 + box_rows, col0:col0 + box_cols]
    box[:part.shape[0], :part.shape[1]] = part
    raw = box.view(np.uint8).reshape(box_rows, 128)
    out = np.zeros(box_rows * 128, np.uint8)
    for r in range(box_rows):
        for u in range(8):
            d = r * 128 + ((u ^ (r % 8)) << 4)
            out[d:d + 16] = raw[r, 16 * u:16 * u + 16]
    return out


def _tma_flat(mat, row0, col0, box_cols, box_rows):
    """The bytes an unswizzled TMA box of ``mat`` lands as in shared
    memory: its rows as they lie, box_cols elements each; zero past the
    matrix."""
    box = np.zeros((box_rows, box_cols), mat.dtype)
    part = mat[row0:row0 + box_rows, col0:col0 + box_cols]
    box[:part.shape[0], :part.shape[1]] = part
    return box.view(np.uint8).reshape(-1)


def _wgmma_addr(start, r, kbyte):
    """The shared-memory byte that wgmma reads for row r, byte kbyte (< 32)
    of a k step of a K-major operand whose descriptor starts at ``start``
    (gemm_sm90.cuh sw128_desc: 8-row groups SBO 1024 bytes apart, rows 128
    bytes apart), the 128-byte swizzle XORing address bits 4-6 with bits
    7-9."""
    addr = start + (r // 8) * 1024 + (r % 8) * 128 + kbyte
    return addr ^ (((addr >> 7) & 7) << 4)


def _emulate_tile(x, w, m0, n0, bn):
    """One tile of the kernel on numpy bytes: unswizzled TMA boxes of x (64
    rows x 128 columns) into chunk buffers, the quantizer's thread map (its
    8 warps; warp qw takes rows 8 qw + 2 j + qh for j < 4, columns 8 qc ..
    8 qc + 7 of each chunk, the row's 16-byte unit qc) into the 128-byte
    swizzled k block slots, then the wgmma
    reads of the slots and of the two consumers' halves of the weight
    stages; returns the s32 tile and the rows' scales, and checks that
    every x element is read once and every slot byte written once."""
    m, k = x.shape
    nkb = -(-k // KB)
    xb = x.view(np.uint16)      # bf16 bits
    xpad = np.zeros((m, nkb * KB), np.uint16)
    xpad[:, :k] = xb
    chunks = [_tma_flat(xb, m0, c * KB, KB, BM) for c in range(nkb)]
    # the kernel's two passes: each row's amax over the chunks, then q
    amax = np.zeros(BM, np.float32)
    reads = np.zeros((BM, nkb * KB), np.int32)
    nj = 4
    for qw in range(8):
        for lane in range(32):
            qh, qc = lane >> 4, lane & 15
            for j in range(nj):
                r = qw * 2 * nj + 2 * j + qh
                for c in range(nkb):
                    off = r * 256 + 16 * qc
                    v = chunks[c][off:off + 16].view(np.uint16)
                    f = (v.astype(np.uint32) << 16).view(np.float32)
                    reads[r, c * KB + 8 * qc:c * KB + 8 * qc + 8] += 1
                    np.testing.assert_array_equal(
                        f, _bf16_f32(xpad[m0 + r, c * KB + 8 * qc:
                                          c * KB + 8 * qc + 8])
                        if m0 + r < m else np.zeros(8, np.float32),
                        err_msg="x read from the wrong swizzled place")
                    amax[r] = max(amax[r], np.abs(f).max())
    assert (reads[:, :k] == 1).all()
    a = np.maximum(amax, np.float32(1e-6))
    inv = (np.float32(127.0) / a).astype(np.float32)
    panel = np.zeros(nkb * BM * KB, np.uint8)
    written = np.zeros_like(panel, np.int32)
    xf = np.zeros((BM, nkb * KB), np.float32)
    rows = min(BM, m - m0)
    xf[:rows, :k] = _bf16_f32(x[m0:m0 + rows])
    for qw in range(8):
        for lane in range(32):
            qh, qc = lane >> 4, lane & 15
            for j in range(nj):
                r = qw * 2 * nj + 2 * j + qh
                for c in range(nkb):
                    v = xf[r, c * KB + 8 * qc:c * KB + 8 * qc + 8]
                    q = np.clip(np.rint(v * inv[r]), -127, 127).astype(np.int8)
                    off = (c * BM * KB + r * 128
                           + (((qc >> 1) ^ (r & 7)) << 4) + (qc & 1) * 8)
                    panel[off:off + 8] = q.view(np.uint8)
                    written[off:off + 8] += 1
    assert (written == 1).all()
    wstages = [_tma_sw128(w, n0, c * KB, KB, bn) for c in range(nkb)]
    acc = np.zeros((BM, bn), np.int64)
    qa = np.zeros((BM, nkb * KB), np.int64)
    wa = np.zeros((bn, nkb * KB), np.int64)
    for c in range(nkb):
        for kk in range(4):
            for kbyte in range(32):
                kcol = c * KB + kk * 32 + kbyte
                for r in range(BM):
                    qa[r, kcol] = panel.view(np.int8)[
                        _wgmma_addr(c * BM * KB + kk * 32, r, kbyte)]
                for cw in range(2):      # the consumers' column halves
                    for r in range(bn // 2):
                        wa[cw * bn // 2 + r, kcol] = wstages[c].view(
                            np.int8)[_wgmma_addr(cw * bn // 2 * 128 + kk * 32,
                                                 r, kbyte)]
    acc += qa @ wa.T
    return acc, a


def _bf16_f32(a):
    """bf16 bits (uint16) -> float32 values."""
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("m,k,n,tile", [
    (70, 256, 96, (64, 0)),      # S1-like K, ragged rows and columns
    (64, 2048, 64, (0, 0)),      # S5's K: 16 k blocks, two passes
    (9, 64, 200, (0, 128)),      # K 64: one box a chunk; a ragged N tile
    (20, 80, 40, (0, 0)),        # K 80: a box partly past K
])
def test_quantizer_writes_the_wgmma_layout(m, k, n, tile):
    rng = np.random.RandomState(m + k)
    x32 = (rng.randn(m, k) * np.logspace(-2, 1, m)[:, None]).astype(
        np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    p = quantize_linear(torch.from_numpy(rng.randn(n, k).astype(np.float32))
                        * 0.05, None)
    plan = int8.h8_plan(m, n, k, SMS)
    m0, n0 = tile
    assert (m0, n0) in {t for block in _walk(plan) for t in block}
    acc, a = _emulate_tile(x.view(torch.int16).numpy(), p.w.numpy(), m0, n0,
                           plan.bn)
    q, s = int8.rowquant(x)
    exact = q.long().numpy() @ p.w.long().numpy().T
    rows, cols = min(BM, m - m0), min(plan.bn, n - n0)
    np.testing.assert_array_equal(acc[:rows, :cols],
                                  exact[m0:m0 + rows, n0:n0 + cols])
    np.testing.assert_array_equal(
        (a[:rows] * np.float32(1 / 127)).astype(np.float32),
        s.reshape(-1).numpy()[m0:m0 + rows])


def test_quant8_bits_equals_quant8_for_every_float():
    """The quantizer rounds off the conversion pipe (common.cuh
    quant8_bits): clip to +-127 with fmin / fmax (NaN gives -127), add 1.5 *
    2^23 in f32, take the low byte. Restated in numpy f32, it equals
    quant8's clip(rint(v)) (rounding half to even, NaN -127) on every f32
    in [-2^8, 2^8] at steps of 2^-12 (every half-way point included), on
    the f32 neighbours of the half-way points, and on zeros, infinities,
    NaN and the extremes; the epilogue's float(acc) for K <= 256 (|acc| <=
    127^2 * 256 < 2^22) is exact the same way."""
    common = (Path(int8.__file__).resolve().parents[2] / "csrc"
              / "common.cuh").read_text()
    assert "__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f)" in \
        " ".join(common.split())
    grid = np.arange(-2 ** 20, 2 ** 20 + 1, dtype=np.float64) / 2 ** 12
    halves = np.arange(-300, 301, dtype=np.float32) + np.float32(0.5)
    v = np.concatenate([
        grid.astype(np.float32), halves, np.nextafter(halves, np.inf),
        np.nextafter(halves, -np.inf),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38,
                  1e-45, -1e-45], np.float32)])
    with np.errstate(invalid="ignore"):
        ref = np.where(np.isnan(v), -127, np.clip(np.rint(v), -127, 127))
    clipped = np.fmin(np.fmax(v, np.float32(-127)), np.float32(127))
    bits = (clipped + np.float32(12582912.0)).astype(np.float32).view(
        np.uint32)
    got = (bits & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(got, ref.astype(np.int8))
    acc = np.array([-127 * 127 * 256, -1, 0, 1, 127 * 127 * 256, 2 ** 22 - 1,
                    -2 ** 22], np.int32)
    f = ((acc + np.int32(0x4B400000)).view(np.float32)
         - np.float32(12582912.0)).astype(np.float32)
    np.testing.assert_array_equal(f, acc.astype(np.float32))


def test_s32_sums_cannot_overflow_at_k_2048():
    """Quantized values lie in [-127, 127], so an s32 sum over the largest
    K the kernel takes (2048, the FFN's output projection) is at most 127^2
    * 2048 = 33,032,192 < 2^31; the extreme operands, summed in int32 by
    numpy (which wraps on overflow), give the exact int64 sums."""
    k = int8.H8_K_MAX
    assert k == 2048 and 127 * 127 * k < 2 ** 31 - 1
    a = np.array([[127] * k, [-127] * k], np.int32)
    w = np.array([[127] * k, [-127] * k, [127, -127] * (k // 2)], np.int32)
    got = a @ w.T
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, a.astype(np.int64) @ w.T.astype(
        np.int64))
    assert got.max() == 127 * 127 * k


@pytest.mark.parametrize("name", sorted(MAIN))
def test_plain_head_path_equals_jax(name):
    """int8_linear_plain against JAX's linear on an int8 pack (layers.py:
    _int8_matmul, the cast to bf16, then the bias added in bf16) at S1-S5's
    widths with fewer rows, on bf16 inputs from one numpy seed; bit for
    bit."""
    _, k, n = MAIN[name]
    m = 70
    rng = np.random.RandomState(k + n)
    x32 = (rng.randn(m, k) * np.logspace(-2, 1, m)[:, None]).astype(
        np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)     # (in, out)
    b = rng.randn(n).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    ref = jax_linear(jax_quantize_linear({"w": jnp.asarray(w),
                                          "b": jnp.asarray(b)}), xj)
    p = quantize_linear(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    out = int8.int8_linear_plain(xt, p)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", [(10, 40, 64), (10, 64, 60), (10, 2064, 64),
                                   (10, 8, 64), (10, 64, 0)])
def test_refused_widths_raise(m, k, n):
    """in not a multiple of 16 or outside 16-2048, out not a positive
    multiple of 8: no plan, so the card's wrapper raises before it
    launches, and never falls back to the plain version or the old tile."""
    with pytest.raises(ValueError):
        int8.h8_plan(m, n, k, SMS)


def test_int8_linear_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 5, 64).astype(np.float32)).to(
        torch.bfloat16)
    p = quantize_linear(torch.from_numpy(rng.randn(96, 64).astype(
        np.float32)) * 0.05, torch.from_numpy(rng.randn(96).astype(
            np.float32)))
    before = int8.int8_linear.launches
    assert torch.equal(int8.int8_linear(x, p), int8.int8_linear_plain(x, p))
    assert int8.int8_linear.launches == before
