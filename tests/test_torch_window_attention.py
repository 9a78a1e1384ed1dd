"""The window attention's two bodies on the CPU (kernel in
toc3d_tpu_torch/csrc/vit_block.cu, wrapper ops/cuda/vit_block.py).

The one-pass body of the bf16 blocks B and C has a plain twin
(``softmax_pv_one_pass_plain``: P rounded at the running max, o and l
rescaled in f32); it must stay within the attention-delta bound of the
two-pass plain version (the int8 blocks' rounding points, and the wrappers'
CPU path) at the main path's window sizes: full windows of 256 and 400 rows,
compressed ones of 201 and 128. With one key tile the two are the same
function. The wrappers choose the body from the weight pack: one-pass for a
bf16 pack, two-pass for an int8 one, and count each body's launches.

The kernel reads bf16 q / k / v with RoPE already applied by kernel G's (or
G8's) QKV epilogue. Its plain twin (``qkv_rope_plain`` at the epilogue's
table rows, ``qkv_table_rows``) must give, bit for bit, what the attention
producer computed before it: f32 q / k / v rotated in f32, then rounded,
in image mode (the pad table of out-of-image tokens included) and rows
mode; and each B, C, B8 and C8 call runs the epilogue once.
"""
import pytest
import torch

from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
from toc3d_tpu_torch.ops.cuda import vit_block
from toc3d_tpu_torch.ops.rope import build_rope_table, rotate_half

BF = torch.bfloat16


def _close(out, ref):
    """The card tests' bound of a bf16 kernel against its plain version:
    max |err| <= 2^-5 max |plain|, mean |err| <= 2^-6 mean |plain|."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(err).all()
    assert err.max().item() <= 2.0 ** -5 * ref.float().abs().max().item()
    assert err.mean().item() <= 2.0 ** -6 * ref.float().abs().mean().item()


def _block(c, heads, hidden, seed):
    blk = Block(EVAViTConfig(embed_dim=c, num_heads=heads,
                             mlp_ratio=hidden / c))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            scale = 0.05 if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale)
            if name.endswith(("norm1.weight", "norm2.weight",
                              "ffn_ln.weight")):
                p.add_(1.0)
    return blk


def _rope(c, heads, ws):
    cos, sin = build_rope_table(c // heads // 2, ws, ws)
    return torch.from_numpy(cos), torch.from_numpy(sin)


# (rows a window, map, ws, ratio): B at ws 16 / 20; C at ws 20 ratio .5
# (k 200 + the representative row) and ws 16 ratio .5 (k 127 + 1)
MAIN_WINDOWS = [(256, (1, 32, 32), 16, None), (400, (1, 30, 50), 20, None),
                (201, (1, 40, 60), 20, 0.5), (128, (1, 32, 32), 16, 0.5)]


@pytest.mark.parametrize("n,shape,ws,ratio", MAIN_WINDOWS)
def test_one_pass_twin_within_attention_delta_bound(n, shape, ws, ratio):
    c, heads = 128, 2
    blk = _block(c, heads, 256, 7)
    wts = vit_block.pack_block_weights(blk, heads, BF)
    g = torch.Generator().manual_seed(7)
    b, h, w = shape
    x = (torch.randn(b, h, w, c, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws)
    plan = None
    if ratio is not None:
        scores = torch.randn(b, h * w, generator=g).to(BF)
        plan = vit_block.compress_plan(scores, b, h, w, ws, ratio, True,
                                       True)
        assert plan.k + 1 == n
    two = vit_block.attention_delta_plain(wts, x, heads, ws, tables, plan)
    one = vit_block.attention_delta_plain(wts, x, heads, ws, tables, plan,
                                          one_pass=True)
    assert not torch.equal(one, two)    # P rounds at the running max
    _close(one, two)


@pytest.mark.parametrize("n", [256, 400, 201, 128])
def test_one_pass_twin_on_peaked_logits(n):
    """Logits of std ~4 (the running max grows across tiles, and the
    rescale matters): the twin's softmax within the same bound."""
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(3, 2, n, 64, generator=g) for _ in range(3))
    q = q * 0.5
    two = vit_block.softmax_pv_plain(q, k, v, BF)
    _close(vit_block.softmax_pv_one_pass_plain(q, k, v, BF), two)


@pytest.mark.parametrize("dt", [BF, torch.float32])
def test_one_pass_twin_is_two_pass_on_one_tile(dt):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 61, 32, generator=g) for _ in range(3))
    assert torch.equal(vit_block.softmax_pv_one_pass_plain(q, k, v, dt),
                       vit_block.softmax_pv_plain(q, k, v, dt))


@pytest.fixture
def launches(monkeypatch):
    """The block chains' launches on CPU tensors with the kernels stubbed
    out: records (C entry point, arguments), and for the QKV epilogue
    ("qkv", (rows, rope, pos, map_shape, ws, int8))."""
    calls = []
    monkeypatch.setattr(vit_block, "call",
                        lambda lib, fn, *a: calls.append((fn, a)))
    monkeypatch.setattr(
        vit_block, "_launch_qkv",
        lambda name, a, w, bias, out, m, rope, pos, map_shape, ws, xs=None,
        scales=None: calls.append(
            ("qkv", (m, rope, pos, map_shape, ws, scales is not None))))
    monkeypatch.setattr(vit_block, "stream_of", lambda t: 0)
    monkeypatch.setattr(vit_block, "window_attention_slots", lambda d: 9)
    monkeypatch.setattr(vit_block, "_ln_in", lambda wts, *a, **kw: (
        (None, None) if vit_block.is_quantized(wts) else None))
    monkeypatch.setattr(vit_block, "_proj", lambda wts, inp, which, m, out,
                        **kw: out)
    return calls


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
def test_body_chosen_from_the_pack(launches, int8, compressed):
    c, heads, ws = 64, 2, 4
    blk = _block(c, heads, 170, 2)
    wts = (vit_block.pack_block_weights_int8 if int8 else
           vit_block.pack_block_weights)(blk, heads, BF)
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(2, 7, 10, c, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws)
    before = (vit_block.window_attention_one_pass.launches,
              vit_block.window_attention_two_pass.launches)
    if compressed:
        scores = torch.randn(2, 70, generator=g).to(BF)
        plan = vit_block.compress_plan(scores, 2, 7, 10, ws, 0.5, True, True)
        vit_block._rows_attention(wts, x, plan, heads, ws, tables)
    else:
        vit_block._full_attention(wts, x, heads, ws, tables)
    fn, args = launches[-1]
    assert fn == "toc3d_window_attention"
    assert args[-2] == int(not int8)           # one_pass
    after = (vit_block.window_attention_one_pass.launches,
             vit_block.window_attention_two_pass.launches)
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((0, 1) if int8 else (1, 0))


def test_window_too_large_for_the_ring_raises(launches):
    qkv = torch.zeros(1, 3 * 64)
    out = torch.zeros(1, 64, dtype=BF)
    with pytest.raises(ValueError, match="does not fit the ring"):
        vit_block.window_attention_launch(qkv, out, (1, 30, 30), 30, 1, 900,
                                          1, True, one_pass=True)
    assert not launches


# ---------------------------------------------------------------------------
# the QKV hand-off: G's / G8's QKV epilogue and its plain twin
# ---------------------------------------------------------------------------

def _old_order(qkv, rope, table_rows, heads, dt=BF):
    """The window attention producer's arithmetic before the QKV epilogue
    took it over: windowed f32 q / k / v (W, n, 3C), q and k rotated in f32
    at table rows (W, n), then q, k and v rounded to dt -> (W, n, 3C)."""
    nw, n, c3 = qkv.shape
    c = c3 // 3
    x = qkv.reshape(nw, n, 3, heads, c // heads)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2].to(dt)
    if rope is not None:
        cos, sin = (t[table_rows][:, :, None] for t in rope)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
    return torch.stack([q.to(dt), k.to(dt), v], 2).reshape(nw, n, c3)


def _window_rows(b, h, w, ws):
    """The qkv row each window place reads in image mode (csrc/vit_block.cu
    WinRows): the map token by geometry, or row B H W + t for an
    out-of-image token at place t -> (W, ws^2) and whether it is a pad."""
    nh, nww = -(-h // ws), -(-w // ws)
    win = torch.arange(b * nh * nww)
    t = torch.arange(ws * ws)
    bb = win // (nh * nww)
    y = (win // nww % nh)[:, None] * ws + t // ws
    x = (win % nww)[:, None] * ws + t % ws
    pad = (y >= h) | (x >= w)
    rows = (bb[:, None] * h + y) * w + x
    return torch.where(pad, b * h * w + t, rows), pad


@pytest.mark.parametrize("ws,shape", [(16, (2, 21, 35)), (20, (1, 30, 50))])
def test_qkv_twin_equals_old_order_image_mode(ws, shape):
    """Image mode on a padded map: the twin's rows gathered by window
    geometry equal the old producer's order on the windowed map (pads: the
    one LN(0) row), bit for bit, and every row of the pad table is that row
    rotated at its window place."""
    c, heads = 128, 2
    b, h, w = shape
    m, n = b * h * w, ws * ws
    g = torch.Generator().manual_seed(ws)
    rope = _rope(c, heads, ws)
    qmap = torch.randn(m, 3 * c, generator=g)
    pad_row = torch.randn(1, 3 * c, generator=g)
    qkv = torch.cat([qmap, pad_row.expand(n, -1)])
    got = vit_block.qkv_rope_plain(
        qkv, rope, vit_block.qkv_table_rows(m + n, map_shape=shape, ws=ws))
    rows, pad = _window_rows(b, h, w, ws)
    assert pad.any() and (rows[pad] >= m).all()
    windows = torch.where(pad[..., None], pad_row, torch.cat(
        [qmap, pad_row])[rows.clamp(max=m)])
    places = torch.arange(n).expand(rows.shape[0], n)
    assert torch.equal(got[rows], _old_order(windows, rope, places, heads))
    table = _old_order(pad_row.expand(1, n, -1), rope, places[:1], heads)
    assert torch.equal(got[m:], table[0])


ROWS_CASES = [(16, 0.5), (20, 0.5), (16, 0.4), (16, 0.3)]


@pytest.mark.parametrize("rep", [True, False])
@pytest.mark.parametrize("ws,ratio", ROWS_CASES)
def test_qkv_twin_equals_old_order_rows_mode(ws, ratio, rep):
    """Rows mode: the gathered rows (kr 128 / 201 / 103 / 77 with the
    representative row) at their pos, bit for bit the old producer's
    order."""
    c, heads = 128, 2
    b, h, w = 1, 2 * ws, 3 * ws
    g = torch.Generator().manual_seed(int(ws / ratio))
    scores = torch.randn(b, h * w, generator=g)
    plan = vit_block.compress_plan(scores, b, h, w, ws, ratio, rep, True)
    pos = plan.slow_idx
    if plan.has_rep:
        pos = torch.cat([pos, torch.full_like(pos[:, :1], plan.k)], 1)
    nw, kr = pos.shape
    if rep:
        assert kr == {(16, 0.5): 128, (20, 0.5): 201, (16, 0.4): 103,
                      (16, 0.3): 77}[(ws, ratio)]
    rope = _rope(c, heads, ws)
    qkv = torch.randn(nw * kr, 3 * c, generator=g)
    got = vit_block.qkv_rope_plain(
        qkv, rope, vit_block.qkv_table_rows(nw * kr, pos.to(torch.int32)))
    assert torch.equal(got.reshape(nw, kr, -1),
                       _old_order(qkv.reshape(nw, kr, -1), rope, pos, heads))


def test_qkv_twin_without_tables_only_rounds():
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(37, 3 * 64, generator=g)
    assert torch.equal(vit_block.qkv_rope_plain(qkv), qkv.to(BF))
    a = torch.randn(37, 64, generator=g).to(BF)
    wq = (torch.randn(192, 64, generator=g) * 0.1).to(BF)
    bias = torch.randn(192, generator=g)
    assert torch.equal(vit_block.gemm_qkv(a, wq, bias),
                       vit_block.gemm_bf16_plain(a, wq, bias,
                                                 out_f32=True).to(BF))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", ["image", "rows"])
def test_gemm_qkv_plain_is_the_block_product_and_twin(int8, mode):
    """gemm_qkv on CPU tensors: the f32 QKV product of the block (_mm, G8's
    dequantization for an int8 pack) through the twin at the epilogue's
    table rows."""
    c, heads, ws = 64, 2, 4
    wts = (vit_block.pack_block_weights_int8 if int8 else
           vit_block.pack_block_weights)(_block(c, heads, 170, 6), heads, BF)
    g = torch.Generator().manual_seed(6)
    shape = (2, 5, 7)
    rows = 70 + ws * ws if mode == "image" else 30
    a = (torch.randn(rows, c, generator=g) * 0.7).to(BF)
    rope = _rope(c, heads, ws)
    pos = None if mode == "image" else \
        torch.randint(0, ws * ws, (rows,), generator=g, dtype=torch.int32)
    kw = dict(rope=rope, pos=pos, map_shape=shape, ws=ws)
    if int8:
        q, xs = vit_block._actquant(a, wts, "qkv")
        got = vit_block.gemm_qkv(q, wts.wqkv, wts.bqkv, xs=xs,
                                 scales=wts.sqkv, **kw)
    else:
        got = vit_block.gemm_qkv(a, wts.wqkv, wts.bqkv, **kw)
    tr = vit_block.qkv_table_rows(rows, pos, shape, ws)
    if mode == "image":
        assert torch.equal(tr[70:], torch.arange(ws * ws))
        assert tr[:70].max() == ws * ws - 1
    ref = vit_block.qkv_rope_plain(vit_block._mm(wts, a, "qkv"), rope, tr)
    assert got.dtype == BF and torch.equal(got, ref)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["full", "padded", "compressed"])
def test_qkv_epilogue_counted_once_per_block_call(launches, monkeypatch,
                                                  int8, kind):
    """One QKV epilogue a B / C / B8 / C8 call, ahead of the window
    attention: at the map's rows plus ws^2 pad rows where windows pass the
    map's edge (the map's rows alone where none does), and for compressed
    rows at their table rows pos (the representative row at place k)."""
    monkeypatch.setattr(vit_block, "_check_block", lambda *a: None)
    c, heads, ws = 64, 2, 4
    blk = _block(c, heads, 170, 2)
    wts = (vit_block.pack_block_weights_int8 if int8 else
           vit_block.pack_block_weights)(blk, heads, BF)
    g = torch.Generator().manual_seed(2)
    shape = (2, 8, 12) if kind == "full" else (2, 7, 10)
    b, h, w = shape
    x = (torch.randn(b, h, w, c, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws)
    before = vit_block.qkv_rope_epilogue.launches
    if kind == "compressed":
        scores = torch.randn(b, h * w, generator=g).to(BF)
        plan = vit_block.compress_plan(scores, b, h, w, ws, 0.5, True, True)
        vit_block._compressed_block("C", wts, x, plan, heads, ws, tables)
    else:
        vit_block._full_block("B", wts, x, heads, ws, tables)
    assert vit_block.qkv_rope_epilogue.launches == before + 1
    names = [fn for fn, _ in launches]
    assert names.count("qkv") == 1
    assert names.index("qkv") < names.index("toc3d_window_attention")
    m, rope, pos, map_shape, ws_, s8 = dict(launches)["qkv"]
    assert s8 == int8 and rope is not None
    if kind == "compressed":
        assert pos.dtype == torch.int32 and pos.shape == (
            plan.slow_idx.shape[0], plan.k + 1)
        assert torch.equal(pos[:, -1], torch.full_like(pos[:, -1], plan.k))
        assert m == pos.numel()
    else:
        assert pos is None and map_shape == shape and ws_ == ws
        assert m == b * h * w + (ws * ws if kind == "padded" else 0)
