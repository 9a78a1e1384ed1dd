"""The row kernels of the port rehearsed on the CPU: the LayerNorm of kernels
B, C, B8 and C8 (toc3d_tpu_torch/csrc/vit_block.cu layernorm_kernel,
wrappers ops/cuda/vit_block.layernorm / layernorm_int8), row quantization,
and the im2col half of the patch embedding A (csrc/patch_embed.cu
patch_im2col_kernel).

* the plain LayerNorm against JAX ``_ln`` (toc3d_tpu/ops/pallas/vit_block.py
  :63) in f32 within 2e-5, with a residual, a stored sum, rows past the
  input's own (LN(0)) and zero columns past the width, at widths 64, 1024
  and 2730 (2736 columns, the sub-LN's);
* ``int8.rowquant`` / ``statquant`` bit-equal to JAX ``_rowquant`` /
  ``_statquant`` (:247, :259) on the same bf16 input, and
  ``layernorm_int8_plain`` within one int8 step of JAX ``_ln`` then
  ``_actquant`` (:271);
* a restatement of the LayerNorm kernel's lane -> access map, with its
  instances read from the source: every column below n is loaded once and
  none past it, every column below npad is stored once, each by the lane
  that loaded it, and no store of a row comes before the row's last load
  (the in-place sub-LN); the wrapper's choice of 16- or 4-byte accesses;
* the im2col kernel's index map restated over an image of distinct values
  equals the plain patch matrix, and im2col + ``gemm_bf16_plain`` equals
  JAX ``patchify_matmul`` in interpret mode in f32 within 2e-5.

tests/test_torch_cuda.py holds the kernels to these plain versions on the
card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from toc3d_tpu.ops.pallas.patch_embed import patchify_matmul as jax_patchify
from toc3d_tpu.ops.pallas.vit_block import _actquant as jax_actquant
from toc3d_tpu.ops.pallas.vit_block import _ln as jax_ln
from toc3d_tpu.ops.pallas.vit_block import _rowquant as jax_rowquant
from toc3d_tpu.ops.pallas.vit_block import _statquant as jax_statquant

from toc3d_tpu_torch.ops.cuda import int8
from toc3d_tpu_torch.ops.cuda import patch_embed as pe
from toc3d_tpu_torch.ops.cuda import vit_block as vb

BF = torch.bfloat16
TOL = dict(atol=2e-5, rtol=2e-5)
CSRC = Path(vb.__file__).resolve().parents[2] / "csrc"
_VIT = (CSRC / "vit_block.cu").read_text()
_PATCH = (CSRC / "patch_embed.cu").read_text()

# (n, npad): LN1 / LN2 at C 1024, the sub-LN's hidden 2730 in 2736 columns,
# and a small width
# ViT-L's width and its sub-LN's 2730 of 2736 columns, ViT-B's 768 and its
# unpadded SwiGLU hidden 2048, and a small width
WIDTHS = [(64, 64), (1024, 1024), (2730, 2736), (768, 768), (2048, 2048)]


def _inputs(seed, xr, npad, n):
    rng = np.random.RandomState(seed)
    x = (rng.randn(xr, npad) * 2 + 0.5).astype(np.float32)
    x[:, n:] = 0
    res = rng.randn(xr, npad).astype(np.float32)
    res[:, n:] = 0
    g = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    return x, res, g, b


def _jax_ref(x, res, g, b, rows, n):
    """JAX _ln of x (+ res) over n columns, rows past x's as zero, zero
    columns past n: the function the kernel computes at each call site."""
    xx = x if res is None else x + res
    xx = np.pad(xx[:, :n], ((0, rows - x.shape[0]), (0, 0)))
    y = np.asarray(jax_ln(jnp.asarray(xx), jnp.asarray(g), jnp.asarray(b)))
    return np.pad(y, ((0, 0), (0, x.shape[1] - n)))


# ---------------------------------------------------------------------------
# the plain LayerNorm and quantization against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,npad", WIDTHS)
@pytest.mark.parametrize("site", ["ln", "res_sum", "ln0_rows"])
def test_plain_layernorm_matches_jax_ln(n, npad, site):
    """f32: the plain version and the CPU wrapper against JAX _ln; with a
    residual the sum is stored; with more output rows than input rows the
    extra rows are LN(0) = beta."""
    xr = 37
    x, res, g, b = _inputs(0, xr, npad, n)
    r = res if site == "res_sum" else None
    rows = xr + 2 if site == "ln0_rows" else xr
    ref = _jax_ref(x, r, g, b, rows, n)
    tx, tg, tb = (torch.from_numpy(t) for t in (x, g, b))
    tr = None if r is None else torch.from_numpy(r)
    plain = vb.layernorm_plain(tx, tg, tb, tr, rows, n)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    s = torch.empty_like(tx)
    out = vb.layernorm(tx, tg, tb, tr, rows, n, sum_out=s)
    assert torch.equal(out, plain)
    assert torch.equal(s, tx if tr is None else tx + tr)
    if site == "ln0_rows":
        np.testing.assert_allclose(ref[xr:, :n], np.broadcast_to(b, (2, n)),
                                   **TOL)
    assert not ref[:, n:].any()


@pytest.mark.parametrize("n", [64, 1024, 2730])
@pytest.mark.parametrize("static", [False, True])
def test_row_quantization_bit_equal_to_jax(n, static):
    """int8.rowquant / statquant on a bf16 input equal JAX _rowquant /
    _statquant on the same values, codes and scales bit for bit."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(23, n) * 3).astype(np.float32)).to(BF)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    if static:
        s = torch.tensor([0.037], dtype=torch.float32)
        q, sc = int8.statquant(x, s)
        qj, scj = jax_statquant(xj, jnp.asarray(s.numpy()).reshape(1, 1))
    else:
        q, sc = int8.rowquant(x)
        qj, scj = jax_rowquant(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sc.numpy().reshape(-1),
                                  np.asarray(scj).reshape(-1))


@pytest.mark.parametrize("n,npad", WIDTHS)
@pytest.mark.parametrize("static", [False, True])
def test_layernorm_int8_plain_within_one_step_of_jax(n, npad, static):
    """The quantizing LayerNorm's plain version on bf16 rows against JAX
    _ln (bf16 out) then _actquant: one int8 step at most (the two LNs may
    round a value to bf16 apart), the rows' scales within 2^-7, and the
    zero columns past n quantized to 0."""
    x, _, g, b = _inputs(2, 19, npad, n)
    tx = torch.from_numpy(x).to(BF)
    sc = torch.tensor([0.03], dtype=torch.float32) if static else None
    q, s = vb.layernorm_int8_plain(tx, torch.from_numpy(g),
                                   torch.from_numpy(b), sc, n=n)
    xj = jnp.asarray(tx[:, :n].float().numpy()).astype(jnp.bfloat16)
    refs = {"attn_in": jnp.asarray(sc.numpy()).reshape(1, 1)} if static \
        else {}
    qj, sj = jax_actquant(jax_ln(xj, jnp.asarray(g), jnp.asarray(b)), refs,
                          "attn_in")
    d = np.abs(q[:, :n].numpy().astype(np.int32)
               - np.asarray(qj).astype(np.int32))
    assert d.max() <= 1 and d.mean() <= 1e-2
    np.testing.assert_allclose(s.numpy().reshape(-1),
                               np.asarray(sj).reshape(-1), rtol=2 ** -7)
    assert not q[:, n:].any()


# ---------------------------------------------------------------------------
# the LayerNorm kernel's lane -> access map
# ---------------------------------------------------------------------------

# the instances toc3d_layernorm picks from, in its order: (the widest npad
# it takes, accesses a thread holds, elements an access, warps a row)
INSTANCES = [tuple(int(v) for v in m) for m in re.findall(
    r"if \(npad <= (\d+)\) return ln_launch<(\d+), (\d+), (\d+)>\(a, s\)",
    _VIT)]
LN_THREADS = int(re.search(r"constexpr int LN_THREADS = (\d+);",
                           _VIT).group(1))


def ln_instance(npad, vec):
    """(accesses a thread holds, warps a row) of the instance
    toc3d_layernorm launches for npad columns at ``vec`` elements an access
    (None: refused)."""
    return next(((ch, wpr) for top, ch, v, wpr in INSTANCES
                 if v == vec and npad <= top), None)


def thread_program(t, ch, vec, wpr, n, npad):
    """Thread t of a row: its memory events on the row in program order,
    ("load", c) for each column it reads, then (after the row's reductions)
    ("store", c) for each column it writes, as layernorm_kernel issues them
    (access j covers columns (32 wpr j + t) * vec ... + vec - 1; a whole
    access below n, else pairs below n; stores up to npad)."""
    loads, stores = [], []
    for j in range(ch):
        c0 = (32 * wpr * j + t) * vec
        loads += [("load", c) for c in range(c0, min(c0 + vec, n))]
        stores += [("store", c) for c in range(c0, min(c0 + vec, npad))]
    return loads, stores


def test_instances_cover_every_width_up_to_the_cap():
    assert LN_THREADS % 32 == 0 and len(INSTANCES) >= 2
    for top, ch, vec, wpr in INSTANCES:
        assert ch * 32 * wpr * vec >= top           # the instance covers it
        assert (LN_THREADS // 32) % wpr == 0        # whole rows a block
    for vec in (8, 2):
        assert max(top for top, _, v, _ in INSTANCES if v == vec) \
            == vb.LN_MAX_WIDTH
    # the main path's widths: one warp a row at 1024 columns, four warps
    # of three 16-byte accesses at the sub-LN's 2736
    assert ln_instance(1024, 8) == (4, 1) and ln_instance(2736, 8) == (3, 4)
    assert ln_instance(vb.LN_MAX_WIDTH + 2, 8) is None


@pytest.mark.parametrize("n,npad,vec", [
    (1024, 1024, 8), (2730, 2736, 8), (64, 64, 8), (170, 176, 8),
    (2730, 2730, 2), (258, 258, 2), (1024, 1024, 2), (4096, 4096, 8),
    (768, 768, 8), (2048, 2048, 8)])
def test_lane_map_loads_and_stores_each_column_once(n, npad, vec):
    ch, wpr = ln_instance(npad, vec)
    loaded, stored, owner = [], [], {}
    for t in range(32 * wpr):
        loads, stores = thread_program(t, ch, vec, wpr, n, npad)
        loaded += [c for _, c in loads]
        stored += [c for _, c in stores]
        for _, c in loads:
            owner[c] = t
        for _, c in stores:
            # in place: a column below n is written by the thread that read
            # it
            assert c >= n or owner.get(c) == t
        for j in range(ch):   # accesses start on their own size
            assert (32 * wpr * j + t) * vec % vec == 0
    assert sorted(loaded) == list(range(n))          # none past n
    assert sorted(stored) == list(range(npad))       # once each


@pytest.mark.parametrize("n,npad", [(2730, 2736), (1024, 1024),
                                   (2048, 2048)])
def test_no_store_precedes_the_rows_last_load(n, npad):
    """The in-place sub-LN (y == x): run the row's threads' programs in a
    random interleaving in which the row's reductions are the only
    synchronisation (no thread passes them before every thread of the row
    has loaded), and check that every store finds the row wholly read."""
    ch, wpr = ln_instance(npad, 8)
    progs = [thread_program(t, ch, 8, wpr, n, npad)
             for t in range(32 * wpr)]
    rng = np.random.RandomState(0)
    events = []
    for phase in (0, 1):        # loads, then (past the reductions) stores
        pos = [0] * len(progs)
        while any(pos[t] < len(p[phase]) for t, p in enumerate(progs)):
            t = rng.choice([t for t, p in enumerate(progs)
                            if pos[t] < len(p[phase])])
            events.append(progs[t][phase][pos[t]])
            pos[t] += 1
    last_load = max(i for i, (k, _) in enumerate(events) if k == "load")
    first_store = min(i for i, (k, _) in enumerate(events) if k == "store")
    assert last_load < first_store
    # and the kernel's source keeps that order: the row's loads, its
    # reductions (a barrier of the row's threads when it spans warps), then
    # every store of the output
    body = _VIT[_VIT.index("layernorm_kernel(const LnArgs a)"):
                _VIT.index("static int ln_launch")]
    assert body.index("ln_load<VEC>(v[j]") < body.index(
        "row_total<WPR, false>(s,") < body.index("ln_store<VEC>(a.y")
    total = _VIT[_VIT.index("float row_total("):
                 _VIT.index("layernorm_kernel(const LnArgs a)")]
    assert "bar.sync" in total and "32 * WPR" in total


@pytest.mark.parametrize("case,want", [
    ((1024, 1024, 0, 0, 16, 256), 8),        # LN1 / LN2: all aligned
    ((2736, 2736, 4096, 4096, 64, 128), 8),  # the sub-LN in place
    ((2730, 2730, 0, 0, 16, 256), 2),        # rows of 5460 bytes
    ((1024, 1024, 4, 0, 16, 256), 2),        # a base 4 bytes off
    ((1024, 1024, 0, 0, 8, 256), 2),         # the LN weight off 16 bytes
    ((1024, 258, 0, 0, 16, 256), 2),         # an output row of 516 bytes
])
def test_access_width_choice(case, want):
    ld, npad, *ptrs = case
    assert vb.ln_access(ld, npad, *ptrs) == want


# ---------------------------------------------------------------------------
# A: im2col, then kernel G's product
# ---------------------------------------------------------------------------

IM2COL_ROWS = int(re.search(r"constexpr int IM2COL_ROWS = (\d+);",
                            _PATCH).group(1))
IM2COL_THREADS = int(re.search(r"constexpr int IM2COL_THREADS = (\d+);",
                               _PATCH).group(1))


def im2col_mirror(x, ps):
    """patch_im2col_kernel's index arithmetic over the whole grid: block
    (bx, by), thread t copies chunk q = bx * THREADS + t of image rows by *
    ROWS ... (16-byte chunks, 8 bf16). Every destination element is written
    exactly once."""
    b, hh, ww, _ = x.shape
    flat = x.reshape(-1)
    row_chunks, run = ww * 3 // 8, ps * 3 // 8
    gh, gw, k = hh // ps, ww // ps, ps * ps * 3
    cols = np.full(b * gh * gw * k, np.nan, dtype=np.float64)
    grid_x = -(-row_chunks // IM2COL_THREADS)
    grid_y = -(-(b * hh) // IM2COL_ROWS)
    q = np.arange(grid_x * IM2COL_THREADS)
    q = q[q < row_chunks]
    j, wq = q // run, q % run
    for by in range(grid_y):
        for p in range(IM2COL_ROWS):
            y = by * IM2COL_ROWS + p
            if y >= b * hh:
                continue
            bi, yy = divmod(y, hh)
            i, r = divmod(yy, ps)
            dst = ((bi * gh + i) * gw + j) * k + r * ps * 3 + wq * 8
            src = y * ww * 3 + q * 8
            for e in range(8):
                assert np.isnan(cols[dst + e]).all()
                cols[dst + e] = flat[src + e]
    assert not np.isnan(cols).any()
    return cols.reshape(b * gh * gw, k)


@pytest.mark.parametrize("b,h,w,ps", [(2, 64, 128, 16), (1, 48, 80, 16),
                                      (1, 16, 24, 8)])
def test_im2col_index_map_equals_the_plain_patch_matrix(b, h, w, ps):
    x = np.arange(b * h * w * 3, dtype=np.float64).reshape(b, h, w, 3)
    ref = pe.patch_im2col_plain(torch.from_numpy(x), ps).numpy()
    np.testing.assert_array_equal(im2col_mirror(x, ps), ref)


@pytest.mark.parametrize("b,h,w,ps,c", [(2, 64, 128, 16, 32),
                                        (1, 80, 160, 16, 64)])
def test_im2col_and_product_match_pallas(b, h, w, ps, c):
    rng = np.random.RandomState(4)
    x = rng.randn(b, h, w, 3).astype(np.float32)
    wgt = (rng.randn(ps, ps, 3, c) * 0.05).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    ref = jax_patchify(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(bias),
                       ps, interpret=True)
    # torch conv layout (C, 3, ps, ps) -> the GEMM's (C, ps*ps*3) operand
    wmat = torch.from_numpy(wgt).permute(3, 0, 1, 2).reshape(c, -1)
    cols = pe.patch_im2col(torch.from_numpy(x), ps)
    out = vb.gemm_bf16_plain(cols, wmat, torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy().reshape(ref.shape),
                               np.asarray(ref), **TOL)
