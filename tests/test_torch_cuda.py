"""The port's CUDA kernels (toc3d_tpu_torch/ops/cuda) against their plain
PyTorch versions on the card, at small shapes that reach the edge cases the
main path of chip_smoke.py does not: ragged maps with zero-padded edge
windows, compressed blocks with and without the representative token and
with RoPE off, ws 16 with and without mxu_align_k, head dims 32 and 64, and
key counts that are not a multiple of the flash kernel's key tile, key
counts that span several splits of the split-K flash kernel with a ragged
last split or fall short of one tile, ws 20 windows (full blocks, and
compressed ones with kr = 201 at ratio .5 and ratio .3), and the window
attention of kr = 201 rows on its own, and at the main path's own shapes
on the 6 x 50 x 100 map (B at ws 16 and 20, C at ratios .5 and .3 with and
without the representative row), each of its two bodies (a bf16 pack: the
one-pass body; an int8 pack: the two-pass body), and each body's launches in
a captured ToC3D_faster_1600 frame. Kernel G's and G8's QKV epilogue (q
and k rotated by RoPE in f32, then bf16) bit for bit the f32 epilogue's
output rotated the same way, at the main path's QKV shapes (B's pad table
included) and small ones (head dim 32, no RoPE), and counted 24 times a
ViT frame and never in a V2-99 one. Kernel G, the bf16 TMA + wgmma GEMM
of B and C, alone with every epilogue, ragged M, N and K (K tails that TMA
zero-fills), and the operands it refuses. The int8
forms B8 / C8 (dynamic and static) and their parts: the mma.sync int8 GEMM
with every epilogue (K not a multiple of the 64-deep tile, M = 1); kernel
G8, the int8 TMA + wgmma GEMM of B8 and C8, bit for bit that GEMM at every
block epilogue and both scale kinds (ragged M and N, K tails, K 2736), and
the operands it refuses; the quantizing LayerNorm and row quantization, and
the head's int8 linear (kernel H8, one launch a call) at small shapes and
at its five main-path shapes, bit for bit the plain version and row
quantization + the mma.sync tile, and the widths it refuses. The patch embedding A (im2col, then kernel G's
product) at small maps and at the main path's (6, 800, 1600), and what it
refuses; the bf16 and quantizing LayerNorm at each call site's width (LN1
with its LN(0) row, LN2 with the residual and the stored sum, the sub-LN's
2730 of 2736 columns in place, and small generic widths), on rows off a
16-byte boundary (the kernel's 4-byte accesses), and what it refuses. The
streaming eval (runtime/eval.streaming_eval) through the captured frame
against eager infer_step on float32 and uint8 eval frames, the token
visualizer's step (infer_step_with_aux) against infer_step, and the loaded
export's captured and eager runs against make_infer_fn. StreamPETR's V2-99
frame at 800x320 (VoVNet-99-eSE on packed cuDNN convolutions, the
two-level CPFPN): captured against eager bit for bit, 106 convolution
launches a frame, and no weight cast or layout transpose in its replayed
backbone+neck program.

Every test needs a CUDA card and skips without one. This file imports no
JAX, so a GPU host without JAX runs it (the tests' conftest.py imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance, bf16 kernel against its plain version on the same bf16 inputs:
max |err| <= 2^-5 * max |plain| and mean |err| <= 2^-6 * mean |plain|, as
in chip_smoke.py (bf16 keeps 8 bits; a flipped last bit of an intermediate
activation can pass through LayerNorm and softmax).
"""
import numpy as np
import pytest
import torch

from toc3d_tpu_torch.layers import quantize_linear
from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig, set_act_scales
from toc3d_tpu_torch.ops.cuda import cross_attn, int8, patch_embed, vit_block
from toc3d_tpu_torch.ops.int8_calib import full_block_site_amax
from toc3d_tpu_torch.ops.rope import build_rope_table

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(err).all()
    assert err.max().item() <= 2.0 ** -5 * ref.float().abs().max().item()
    assert err.mean().item() <= 2.0 ** -6 * ref.float().abs().mean().item()


def _block(c, heads, hidden, seed, dev):
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
    assert blk.mlp.w1.out_features == hidden
    return blk.to(dev)


def _rope(c, heads, ws, dev):
    cos, sin = build_rope_table(c // heads // 2, ws, ws)
    return torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)


def _counted(fn, *args, **kw):
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 64, 128, 64), (1, 48, 80, 128),
                                     (6, 800, 1600, 1024)])
def test_patchify_kernel(dev, b, h, w, c):
    """Kernel A, im2col and kernel G's product, at small maps and at the
    main path's (6, 800, 1600) -> (6, 50, 100, 1024); its im2col launch
    alone is the plain patch matrix exactly. A's product does not count as
    a launch of kernel G."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, h, w, 3, device=dev, generator=g).to(BF)
    wmat = (torch.randn(c, 768, device=dev, generator=g) * 0.05).to(BF)
    bias = torch.randn(c, device=dev, generator=g)
    g_before = vit_block._gemm.launches
    out = _counted(patch_embed.patchify_matmul, x, wmat, bias, 16)
    assert vit_block._gemm.launches == g_before
    _close(out, patch_embed.patchify_plain(x, wmat, bias, 16))
    assert torch.equal(patch_embed.patch_im2col(x, 16),
                       patch_embed.patch_im2col_plain(x, 16))


@pytest.mark.cuda
def test_patchify_refuses_what_it_cannot_take(dev):
    x = torch.randn(1, 32, 48, 3, device=dev).to(BF)
    wmat = torch.randn(64, 768, device=dev).to(BF)
    bias = torch.zeros(66, device=dev)
    before = patch_embed.patchify_matmul.launches
    with pytest.raises(ValueError):          # f32 image
        patch_embed.patchify_matmul(x.float(), wmat, bias[:64], 16)
    with pytest.raises(ValueError):          # W not a multiple of 8
        patch_embed.patchify_matmul(
            torch.randn(1, 32, 36, 3, device=dev).to(BF), wmat, bias[:64], 12)
    with pytest.raises(ValueError):          # C not a multiple of 8
        patch_embed.patchify_matmul(x, wmat[:60], bias[:60], 16)
    with pytest.raises(ValueError):          # bias off 8 bytes
        patch_embed.patchify_matmul(x, wmat, bias[1:65], 16)
    with pytest.raises(ValueError):          # K of another patch size
        patch_embed.patchify_matmul(x, wmat[:, :192], bias[:64], 16)
    assert patch_embed.patchify_matmul.launches == before


# the LayerNorm call sites of B, C, B8 and C8 at small row counts: (x rows,
# output rows, n, npad, res); LN1 of B has one output row more (LN(0)), LN2
# of C adds a residual and stores the sum, the sub-LN runs in place on the
# gate output's 2736 columns of which 2730 are the hidden width; 64 and 258
# take the generic instances
LN_SITES = {"ln1_full": (37, 38, 1024, 1024, False),
            "ln1_rows": (129, 129, 1024, 1024, False),
            "ln2_rows": (41, 41, 1024, 1024, True),
            "sub_ln": (33, 33, 2730, 2736, False),
            "vit_b_ln2_rows": (41, 41, 768, 768, True),
            "vit_b_sub_ln": (33, 33, 2048, 2048, False),
            "tiny": (5, 6, 64, 64, True),
            "odd_pairs": (7, 7, 258, 258, True)}


def _ln_inputs(dev, xr, n, npad, res, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(xr, npad, device=dev, generator=g) * 2 + 0.5).to(BF)
    x[:, n:] = 0
    r = (torch.randn(xr, npad, device=dev, generator=g).to(BF) if res
         else None)
    wgt = 1 + 0.1 * torch.randn(n, device=dev, generator=g)
    bias = 0.1 * torch.randn(n, device=dev, generator=g)
    return x, r, wgt, bias


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(LN_SITES))
@pytest.mark.parametrize("mode", ["out", "in_place", "misaligned"])
def test_layernorm_kernel(dev, site, mode):
    """The bf16 LayerNorm at each call site's width: a new output, in place
    (y == x; the sub-LN's form), and on rows whose base is 4 bytes off a
    16-byte boundary (the kernel's 4-byte accesses). With a residual the
    stored sum is the bf16 sum exactly."""
    xr, rows, n, npad, res = LN_SITES[site]
    if mode == "in_place":
        rows = xr
    x, r, wgt, bias = _ln_inputs(dev, xr, n, npad, res, 11)
    if mode == "misaligned":
        buf = torch.empty(xr * npad + 2, dtype=BF, device=dev)
        x = buf[2:].view(xr, npad).copy_(x)
        assert vit_block.ln_access(npad, npad, x.data_ptr()) == 2
    ref = vit_block.layernorm_plain(x, wgt, bias, r, rows, n)
    want_sum = (x.float() + r.float()).to(BF) if res else None
    s = torch.empty_like(x) if res else None
    out = _counted(vit_block.layernorm, x, wgt, bias, r, rows, n, s,
                   x if mode == "in_place" else None)
    if mode == "in_place":
        assert out.data_ptr() == x.data_ptr()
    _close(out, ref)
    assert torch.equal(out[:, n:], torch.zeros_like(out[:, n:]))
    if res:
        assert torch.equal(s, want_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["ln1_full", "ln2_rows", "sub_ln",
                                  "vit_b_ln2_rows", "vit_b_sub_ln"])
@pytest.mark.parametrize("static", [False, True])
def test_layernorm_int8_kernel_at_call_sites(dev, site, static):
    """The quantizing LayerNorm at the main path's widths, the LN(0) row
    and the sub-LN's six zero columns included: one int8 step at most, in
    few places, and the rows' scales within 2^-7."""
    xr, rows, n, npad, res = LN_SITES[site]
    x, r, wgt, bias = _ln_inputs(dev, xr, n, npad, res, 12)
    sc = torch.tensor([0.04], device=dev) if static else None
    q, s = vit_block.layernorm_int8(x, wgt, bias, sc, r, rows, n)
    qr, sr = vit_block.layernorm_int8_plain(x, wgt, bias, sc, r, rows, n)
    assert q.shape == (rows, npad) and torch.equal(q[:, n:],
                                                   torch.zeros_like(q[:, n:]))
    torch.testing.assert_close(s, sr.reshape(s.shape), rtol=2 ** -7, atol=0)
    d = (q.int() - qr.int()).abs()
    assert d.max().item() <= 1 and d.float().mean().item() <= 1e-2


@pytest.mark.cuda
def test_layernorm_refuses_what_it_cannot_take(dev):
    x, _, wgt, bias = _ln_inputs(dev, 4, 64, 64, False, 13)
    before = vit_block.layernorm.launches
    with pytest.raises(ValueError):          # f32 rows
        vit_block.layernorm(x.float(), wgt, bias)
    with pytest.raises(ValueError):          # odd width
        vit_block.layernorm(x, wgt, bias, n=63)
    with pytest.raises(ValueError):          # wider than the registers hold
        vit_block.layernorm(torch.zeros(2, 4098, dtype=BF, device=dev),
                            torch.ones(4098, device=dev),
                            torch.zeros(4098, device=dev))
    with pytest.raises(ValueError):          # fewer output rows than x's
        vit_block.layernorm(x, wgt, bias, rows=3)
    with pytest.raises(ValueError):          # residual of another shape
        vit_block.layernorm(x, wgt, bias, res=x[:2])
    with pytest.raises(ValueError):          # weight shorter than the width
        vit_block.layernorm(x, wgt[:32], bias[:32])
    with pytest.raises(ValueError):          # rows off a 4-byte boundary
        buf = torch.zeros(4 * 64 + 1, dtype=BF, device=dev)
        vit_block.layernorm(buf[1:].view(4, 64), wgt, bias)
    with pytest.raises(ValueError):
        vit_block.layernorm_int8(x, wgt, bias, n=65)
    assert vit_block.layernorm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,heads,hidden,ws,rope", [
    ((2, 7, 11), 64, 2, 170, 4, True),       # ragged map, edge pads
    ((2, 7, 11), 64, 2, 170, 4, False),
    ((1, 20, 20), 128, 2, 256, 16, True),    # head_dim 64, ws 16
    ((1, 40, 40), 128, 2, 256, 20, True),    # ws 20: 400 keys, 25 q tiles
    ((1, 30, 50), 128, 2, 256, 20, True),    # ws 20 with edge pads
])
def test_full_block_kernel(dev, shape, c, heads, hidden, ws, rope):
    blk = _block(c, heads, hidden, 1, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(*shape, c, device=dev, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws, dev) if rope else None
    out = _counted(vit_block.fused_full_block, blk, x, heads, ws, tables)
    wts = vit_block.pack_block_weights(blk, heads, BF)
    _close(out, vit_block.full_block_plain(wts, x, heads, ws, tables))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,heads,hidden,ws,use_rep,rope_acc,align", [
    ((2, 7, 10), 64, 2, 170, 4, True, True, True),
    ((2, 7, 10), 64, 2, 170, 4, False, True, True),
    ((2, 7, 10), 64, 2, 170, 4, True, False, True),
    ((1, 20, 20), 128, 2, 256, 16, True, True, True),    # k = 127
    ((1, 20, 20), 128, 2, 256, 16, True, True, False),   # k = 128
])
def test_compressed_block_kernel(dev, shape, c, heads, hidden, ws, use_rep,
                                 rope_acc, align):
    _compressed_case(dev, shape, c, heads, hidden, ws, 0.5, use_rep,
                     rope_acc, align)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio,use_rep", [(0.5, True), (0.5, False),
                                           (0.3, True), (0.3, False)])
def test_compressed_block_kernel_ws20(dev, ratio, use_rep):
    """ws 20 windows as on the main path's global layers: kr = 201 rows at
    ratio .5 (13 query tiles), 121 at ratio .3, with and without the
    representative row."""
    _compressed_case(dev, (1, 40, 60), 128, 2, 256, 20, ratio, use_rep,
                     True, True)


def _compressed_case(dev, shape, c, heads, hidden, ws, ratio, use_rep,
                     rope_acc, align):
    blk = _block(c, heads, hidden, 2, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    b, h, w = shape
    x = (torch.randn(b, h, w, c, device=dev, generator=g) * 0.5).to(BF)
    scores = torch.randn(b, h * w, device=dev, generator=g).to(BF)
    tables = _rope(c, heads, ws, dev)
    out = _counted(vit_block.fused_compressed_block, blk, x, scores, heads,
                   ws, ratio, tables, use_rep, rope_acc, align)
    plan = vit_block.compress_plan(scores, b, h, w, ws, ratio, use_rep, align)
    wts = vit_block.pack_block_weights(blk, heads, BF)
    ref = vit_block.compressed_block_plain(wts, x, plan, heads, ws,
                                           tables if rope_acc else None)
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,heads,hidden,ws,use_rep,compressed", [
    ((2, 7, 11), 64, 2, 170, 4, True, False),     # full block, edge pads
    ((1, 40, 40), 128, 2, 256, 20, True, False),  # full block, ws 20
    ((2, 7, 10), 64, 2, 170, 4, True, True),      # rows + representative
    ((1, 20, 20), 128, 2, 256, 16, False, True),  # k = 127, no rep
    ((1, 40, 60), 128, 2, 256, 20, True, True),   # kr = 201, ws 20
])
def test_attention_delta_kernel(dev, shape, c, heads, hidden, ws, use_rep,
                                compressed):
    """The attention half alone (the block output is mostly residual and
    MLP, which would hide a RoPE or pad-mask error in it)."""
    blk = _block(c, heads, hidden, 4, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    b, h, w = shape
    x = (torch.randn(b, h, w, c, device=dev, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws, dev)
    plan = None
    if compressed:
        scores = torch.randn(b, h * w, device=dev, generator=g).to(BF)
        plan = vit_block.compress_plan(scores, b, h, w, ws, 0.5, use_rep,
                                       True)
    before = vit_block.fused_full_block.launches
    out = vit_block.attention_delta(blk, x, heads, ws, tables, plan)
    assert vit_block.fused_full_block.launches == before
    wts = vit_block.pack_block_weights(blk, heads, BF)
    _close(out, vit_block.attention_delta_plain(wts, x, heads, ws, tables,
                                                plan))


# the main path's window attention shapes on the 6 x 50 x 100 map: B at ws 16
# (168 windows of 256 rows) and ws 20 (90 of 400), C at ws 16 / 20 and
# ratios .5 / .3 with and without the representative row (k 127 / 76 at ws
# 16, 200 / 120 at ws 20): the ring's wave tails over 132 SMs
MAIN_ATTENTION = [(16, None, True), (20, None, True)] + [
    (ws, ratio, rep) for ws in (16, 20) for ratio in (0.5, 0.3)
    for rep in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ws,ratio,rep", MAIN_ATTENTION)
def test_window_attention_main_shapes(dev, ws, ratio, rep, int8):
    """window_attention_launch at the main path's own shapes (ViT-L, 16
    heads of 64), through the attention delta of B / C (a bf16 pack: the
    one-pass body) and of B8 / C8 (an int8 pack, dynamic: the two-pass
    body), against the plain version; each launch counted on its body."""
    blk = _block(1024, 16, 2730, 8, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(6, 50, 100, 1024, device=dev, generator=g) * 0.5).to(BF)
    tables = _rope(1024, 16, ws, dev)
    plan = None
    if ratio is not None:
        scores = torch.randn(6, 5000, device=dev, generator=g).to(BF)
        plan = vit_block.compress_plan(scores, 6, 50, 100, ws, ratio, rep,
                                       True)
    bodies = (vit_block.window_attention_one_pass,
              vit_block.window_attention_two_pass)
    before = [b.launches for b in bodies]
    out = vit_block.attention_delta(blk, x, 16, ws, tables, plan, int8=int8)
    assert [b.launches - n for b, n in zip(bodies, before)] == \
        ([0, 1] if int8 else [1, 0])
    pack = vit_block.pack_block_weights_int8 if int8 else \
        vit_block.pack_block_weights
    _close(out, vit_block.attention_delta_plain(pack(blk, 16, BF), x, 16, ws,
                                                tables, plan))


def _rope2_bf16(v, rope, tr):
    """bf16 of the kernels' rope2 on the f32 (rows, 3C) v at table rows tr:
    each pair (a, b) of q and k goes to fma(a, c0, fl(-b s0)) and fma(b, c1,
    fl(a s1)) (products exact in f64, the FMA's rounding through f64), v as
    it is."""
    if rope is None:
        return v.to(BF)
    rows, c3 = v.shape
    cos, sin = (t[tr].double().reshape(rows, 1, -1, 2) for t in rope)
    qk = v[:, :2 * c3 // 3].double().reshape(rows, -1, cos.shape[2], 2)
    a, b = qk[..., 0], qk[..., 1]
    na = (a * cos[..., 0] + (-b * sin[..., 0]).float().double()).float()
    nb = (b * cos[..., 1] + (a * sin[..., 1]).float().double()).float()
    qk = torch.stack([na, nb], -1).reshape(rows, -1)
    return torch.cat([qk.to(BF), v[:, 2 * c3 // 3:].to(BF)], 1)


def _qkv_case(dev, g, shape, ws, ratio, rep, align=True):
    """(rows, pos) of a QKV call: a full block's map rows and, where windows
    pass the map's edge, its ws^2 pad rows; or a compressed block's rows at
    their table rows."""
    b, h, w = shape
    if ratio is None:
        pads = h % ws or w % ws
        return b * h * w + (ws * ws if pads else 0), None
    scores = torch.randn(b, h * w, device=dev, generator=g).to(BF)
    plan = vit_block.compress_plan(scores, b, h, w, ws, ratio, rep, align)
    pos = plan.slow_idx
    if plan.has_rep:
        pos = torch.cat([pos, torch.full_like(pos[:, :1], plan.k)], 1)
    pos = pos.to(torch.int32).contiguous()
    return pos.numel(), pos


def _check_qkv_epilogue(dev, g, int8_, c, heads, shape, ws, rows, pos,
                        rope):
    """gemm_qkv (G, or G8 with int8_) against bf16(rope2(the same kernel's
    f32 output)) bit for bit, one launch counted on G or G8."""
    n = 3 * c
    if int8_:
        aq, xs, wq, sc, bias, _ = _s8_operands(dev, rows, n, c, False,
                                               rows + n)
        f32 = int8.gemm_s8_sm90(aq, xs, wq, sc, bias, out_f32=True)
        kw = dict(xs=xs, scales=sc)
        counter, a, wt = int8.gemm_s8_sm90, aq, wq
    else:
        a = torch.randn(rows, c, device=dev, generator=g).to(BF)
        wt = (torch.randn(n, c, device=dev, generator=g) * c ** -0.5).to(BF)
        bias = torch.randn(n, device=dev, generator=g)
        f32 = vit_block.gemm_bf16(a, wt, bias, out_f32=True)
        kw, counter = {}, vit_block._gemm
    before = counter.launches
    got = vit_block.gemm_qkv(a, wt, bias, rope=rope, pos=pos,
                             map_shape=shape, ws=ws, **kw)
    assert counter.launches == before + 1
    tr = None if rope is None else vit_block.qkv_table_rows(
        rows, pos, shape, ws).to(dev)
    assert got.dtype == BF and got.shape == (rows, n)
    assert torch.equal(got, _rope2_bf16(f32, rope, tr))


# the QKV calls of the main path's blocks on the 6 x 50 x 100 map: B at ws
# 16 / 20 (both pass the map's edge: the pad table), C at ws 16, ratios .5
# and .3, with and without the representative row
MAIN_QKV = [(16, None, True), (20, None, True)] + [
    (16, ratio, rep) for ratio in (0.5, 0.3) for rep in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8_", [False, True])
@pytest.mark.parametrize("ws,ratio,rep", MAIN_QKV)
def test_qkv_epilogue_main_shapes(dev, ws, ratio, rep, int8_):
    """Kernel G's and G8's QKV epilogue at the main path's shapes (ViT-L,
    16 heads of 64): bf16 q / k / v equal to bf16(rope2(the f32 epilogue's
    output)), bit for bit, the pad table's rows included."""
    g = torch.Generator(device=dev).manual_seed(ws + int(10 * (ratio or 0)))
    shape = (6, 50, 100)
    rows, pos = _qkv_case(dev, g, shape, ws, ratio, rep)
    _check_qkv_epilogue(dev, g, int8_, 1024, 16, shape, ws, rows, pos,
                        _rope(1024, 16, ws, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("int8_", [False, True])
@pytest.mark.parametrize("c,heads,mode,tables", [
    (64, 2, "image", True),     # head_dim 32, N 192: q, k, v in one tile
    (64, 2, "rows", True),
    (128, 2, "image", False),   # no RoPE: the rounding alone
    (128, 2, "rows", True)])
def test_qkv_epilogue_small(dev, c, heads, mode, tables, int8_):
    g = torch.Generator(device=dev).manual_seed(c + heads)
    shape, ws = (2, 7, 11), 4
    rows, pos = _qkv_case(dev, g, shape, ws, None if mode == "image" else
                          0.5, True)
    _check_qkv_epilogue(dev, g, int8_, c, heads, shape, ws, rows, pos,
                        _rope(c, heads, ws, dev) if tables else None)


@pytest.mark.cuda
@pytest.mark.parametrize("b,q,kv,c,heads", [
    (2, 37, 130, 64, 2),      # head_dim 32, ragged Q and K
    (1, 70, 300, 128, 2),     # head_dim 64
    (1, 64, 128, 256, 8),     # tile-aligned
    (1, 900, 5000, 256, 8),   # 5 splits, ragged last split, ragged q tile
    (1, 900, 1668, 256, 8),   # the decoder's self-attention: 4 splits
    (1, 200, 3000, 128, 2),   # head_dim 64, 6 splits
    (2, 5, 40, 64, 2),        # fewer keys than one tile
])
def test_flash_kernel(dev, b, q, kv, c, heads):
    g = torch.Generator(device=dev).manual_seed(3)
    qq = (torch.randn(b, q, c, device=dev, generator=g)
          * (c // heads) ** -0.5).to(BF)
    k = torch.randn(b, kv, c, device=dev, generator=g).to(BF)
    v = torch.randn(b, kv, c, device=dev, generator=g).to(BF)
    out = _counted(cross_attn.flash_attention_core, qq, k, v, heads)
    _close(out, cross_attn.flash_attention_plain(qq, k, v, heads))


def _gemm_case(dev, m, n, k, epi):
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, k, device=dev, generator=g).to(BF)
    w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).to(BF)
    kw = dict(bias=None if epi == "nobias" else
              torch.randn(n, device=dev, generator=g),
              res=torch.randn(m, n, device=dev, generator=g).to(BF)
              if epi == "res" else None,
              out_f32=epi == "f32", gate=epi == "gate")
    before = vit_block._gemm.launches
    out = vit_block.gemm_bf16(a, w, **kw)
    assert vit_block._gemm.launches == before + 1
    ref = vit_block.gemm_bf16_plain(a, w, **kw)
    err = (out.float() - ref.float()).abs()
    # shown with -rP: the worst of these is quoted in the tests' docstring
    print(f"gemm_bf16 {m}x{n}x{k} {epi}: max |err| / max |plain| "
          f"{err.max().item() / ref.float().abs().max().item():.3g}, mean "
          f"|err| / mean |plain| "
          f"{err.mean().item() / ref.float().abs().mean().item():.3g}")
    if epi == "f32":
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert err.max().item() <= 1e-5 * ref.abs().max().item()
    else:
        _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["f32", "bias", "res", "gate", "nobias"])
@pytest.mark.parametrize("k", [48, 1024, 2736])
@pytest.mark.parametrize("n", [136, 1024, 5472])
@pytest.mark.parametrize("m", [1, 63, 129, 30001])
def test_gemm_bf16_kernel(dev, m, n, k, epi):
    """Kernel G against gemm_bf16_plain: the f32 output within 1e-5 of
    max |plain| (the sums' order only), the bf16 epilogues within the
    kernel bounds. Measured worst over these cases on an NVIDIA H100 80GB
    HBM3 (-rP prints each): f32 4.55e-06 of max |plain| (30001 x 136 x
    2736); bf16 0.00667 of max |plain| (the residual epilogue, 30001 x 1024
    x 1024: one bf16 step of a rounding that flips) and a mean of 5.29e-06
    of mean |plain| (the gate)."""
    _gemm_case(dev, m, n, k, epi)


@pytest.mark.cuda
def test_gemm_bf16_refuses_what_tma_cannot_read(dev):
    """Row strides must be multiples of 16 bytes, the operands bf16 and
    the f32 bias on an 8-byte boundary (the epilogue reads it in pairs);
    the wrapper raises rather than launching."""
    a = torch.randn(8, 44, device=dev).to(BF)
    with pytest.raises(ValueError):
        vit_block.gemm_bf16(a, torch.randn(16, 44, device=dev).to(BF))
    with pytest.raises(ValueError):
        vit_block.gemm_bf16(torch.randn(8, 64, device=dev),
                            torch.randn(16, 64, device=dev).to(BF))
    with pytest.raises(ValueError):
        vit_block.gemm_bf16(torch.randn(8, 64, device=dev).to(BF),
                            torch.randn(15, 64, device=dev).to(BF))
    a, w = (torch.randn(8, 64, device=dev).to(BF),
            torch.randn(16, 64, device=dev).to(BF))
    bias = torch.randn(18, device=dev)
    before = vit_block._gemm.launches
    with pytest.raises(ValueError):
        vit_block.gemm_bf16(a, w, bias[1:])
    assert vit_block._gemm.launches == before
    # the aligned view of the same storage launches, and the context lives
    out = vit_block.gemm_bf16(a, w, bias[2:])
    _close(out, vit_block.gemm_bf16_plain(a, w, bias[2:]))


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor the kernel does not take raises; it is not routed to
    the plain version."""
    q = torch.randn(1, 8, 64, device=dev)          # float32
    with pytest.raises(ValueError):
        cross_attn.flash_attention_core(q, q, q, 2)
    blk = _block(64, 2, 170, 0, dev)
    with pytest.raises(ValueError):
        vit_block.fused_full_block(blk, torch.randn(1, 4, 4, 64, device=dev),
                                   2, 4, None)
    with pytest.raises(ValueError):
        vit_block.fused_full_block_int8(
            blk, torch.randn(1, 4, 4, 64, device=dev), 2, 4, None)
    with pytest.raises(ValueError):
        int8.row_quant(torch.randn(4, 64, device=dev))


# ---------------------------------------------------------------------------
# int8: B8 / C8 and their kernels
# ---------------------------------------------------------------------------

def _calibrate(blk, x, heads, ws, tables):
    """Static site scales of blk from its own input (plain probe)."""
    amax = full_block_site_amax(blk, x, heads, ws, tables)
    set_act_scales(blk, (amax.float() / 127.0).tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape,c,heads,hidden,ws", [
    ((2, 7, 11), 64, 2, 170, 4),      # ragged map, edge pads, hp 176
    ((1, 20, 20), 128, 2, 256, 16),   # head_dim 64, ws 16
])
def test_full_block_int8_kernel(dev, shape, c, heads, hidden, ws, static):
    blk = _block(c, heads, hidden, 5, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(*shape, c, device=dev, generator=g) * 0.5).to(BF)
    tables = _rope(c, heads, ws, dev)
    if static:
        _calibrate(blk, x, heads, ws, tables)
    out = _counted(vit_block.fused_full_block_int8, blk, x, heads, ws, tables)
    wts = vit_block.pack_block_weights_int8(blk, heads, BF)
    assert vit_block.is_quantized(wts) == ("static" if static else "dynamic")
    _close(out, vit_block.full_block_plain(wts, x, heads, ws, tables))
    _close(vit_block.attention_delta(blk, x, heads, ws, tables, int8=True),
           vit_block.attention_delta_plain(wts, x, heads, ws, tables))


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape,c,heads,hidden,ws,use_rep,align", [
    ((2, 7, 10), 64, 2, 170, 4, True, True),
    ((2, 7, 10), 64, 2, 170, 4, False, True),
    ((1, 20, 20), 128, 2, 256, 16, True, True),    # k = 127
])
def test_compressed_block_int8_kernel(dev, shape, c, heads, hidden, ws,
                                      use_rep, align, static):
    blk = _block(c, heads, hidden, 6, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    b, h, w = shape
    x = (torch.randn(b, h, w, c, device=dev, generator=g) * 0.5).to(BF)
    scores = torch.randn(b, h * w, device=dev, generator=g).to(BF)
    tables = _rope(c, heads, ws, dev)
    if static:
        _calibrate(blk, x, heads, ws, tables)
    out = _counted(vit_block.fused_compressed_block_int8, blk, x, scores,
                   heads, ws, 0.5, tables, use_rep, True, align)
    plan = vit_block.compress_plan(scores, b, h, w, ws, 0.5, use_rep, align)
    wts = vit_block.pack_block_weights_int8(blk, heads, BF)
    _close(out, vit_block.compressed_block_plain(wts, x, plan, heads, ws,
                                                 tables))
    _close(vit_block.attention_delta(blk, x, heads, ws, tables, plan,
                                     int8=True),
           vit_block.attention_delta_plain(wts, x, heads, ws, tables, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["plain", "bias", "res", "gate", "f32",
                                 "head", "static"])
@pytest.mark.parametrize("m,n,k", [(1, 64, 48), (130, 96, 80),
                                   (257, 272, 1040)])
def test_int8_gemm_kernel(dev, m, n, k, epi):
    """Every epilogue of the int8 GEMM. The int32 sums are exact on both
    sides and the dequantization is the same f32 product, so the f32 and
    bias outputs must be equal; the rest round to bf16 the same way, and
    the gate's silu may differ in its last f32 bit."""
    g = torch.Generator(device=dev).manual_seed(7)
    aq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                       dtype=torch.int8)
    xs = torch.rand(1 if epi == "static" else m, device=dev,
                    generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, device=dev, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(n, device=dev, generator=g)
    res = torch.randn(m, n, device=dev, generator=g).to(BF)
    kw = dict(bias=None if epi == "plain" else bias,
              res=res if epi == "res" else None, out_f32=epi == "f32",
              gate=epi == "gate", head=epi == "head")
    out = int8.gemm_s8(aq, xs, wq, ws, **kw)
    ref = int8.gemm_s8_plain(aq, xs, wq, ws, **kw)
    if epi in ("f32", "bias", "plain", "static", "head"):
        assert torch.equal(out, ref.to(out.dtype))
    else:
        _close(out, ref)


def _s8_operands(dev, m, n, k, static, seed):
    """int8 operands over their whole range, row (or one static) and
    channel scales, an f32 bias and a bf16 residual."""
    g = torch.Generator(device=dev).manual_seed(seed)
    aq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                       dtype=torch.int8)
    xs = torch.rand(1 if static else m, device=dev, generator=g) * 0.01 \
        + 1e-3
    ws = torch.rand(n, device=dev, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(n, device=dev, generator=g)
    res = torch.randn(m, n, device=dev, generator=g).to(BF)
    return aq, xs, wq, ws, bias, res


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("epi", ["f32", "bias", "res", "gate", "plain"])
@pytest.mark.parametrize("m,n,k", [
    (1, 64, 48),          # one row, one K tile of 128 mostly zero-filled
    (130, 96, 80),        # M past one 128-row tile
    (257, 272, 1040),     # ragged N past one 256-column tile, K tail 16
    (30001, 136, 1024),   # the main path's rows, ragged N
    (300, 1024, 2736),    # w3's K: 21.375 tiles of 128
])
def test_gemm_s8_sm90_kernel(dev, m, n, k, epi, static):
    """Kernel G8 against the mma.sync tile (gemm_s8) on the same operands:
    the int32 sums are exact in both and every epilogue keeps epilogue2's
    rounding points (the gate its expf and IEEE division), so the outputs
    are equal bit for bit; the f32 output also equals gemm_s8_plain."""
    aq, xs, wq, ws, bias, res = _s8_operands(dev, m, n, k, static, m + n + k)
    kw = dict(bias=None if epi == "plain" else bias,
              res=res if epi == "res" else None, out_f32=epi == "f32",
              gate=epi == "gate")
    out = _counted(int8.gemm_s8_sm90, aq, xs, wq, ws, **kw)
    assert out.shape == ((m, n // 2) if epi == "gate" else (m, n))
    assert torch.equal(out, int8.gemm_s8(aq, xs, wq, ws, **kw))
    if epi == "f32":
        assert torch.equal(out, int8.gemm_s8_plain(aq, xs, wq, ws, **kw))


@pytest.mark.cuda
def test_gemm_s8_sm90_refuses_what_tma_cannot_read(dev):
    """K must be a multiple of 16 (16-byte rows), N even, the operands
    int8, and the f32 bias and channel scales on an 8-byte boundary (the
    epilogue reads them in pairs); the wrapper raises rather than
    launching, and never falls back to the mma.sync tile."""
    aq, xs, wq, ws, bias, _ = _s8_operands(dev, 8, 18, 64, False, 1)
    before = (int8.gemm_s8_sm90.launches, int8.int8_linear.launches)
    with pytest.raises(ValueError):          # K 40
        int8.gemm_s8_sm90(aq[:, :40].contiguous(), xs,
                          wq[:, :40].contiguous(), ws)
    with pytest.raises(ValueError):          # N 17
        int8.gemm_s8_sm90(aq, xs, wq[:17], ws)
    with pytest.raises(ValueError):          # bf16 operands
        int8.gemm_s8_sm90(aq.to(BF), xs, wq.to(BF), ws)
    with pytest.raises(ValueError):          # channel scales off 8 bytes
        int8.gemm_s8_sm90(aq, xs, wq[:16], ws[1:17])
    with pytest.raises(ValueError):          # bias off 8 bytes
        int8.gemm_s8_sm90(aq, xs, wq[:16], ws[:16], bias[1:17])
    assert (int8.gemm_s8_sm90.launches, int8.int8_linear.launches) == before
    # the aligned views of the same storage launch, and the context lives
    out = int8.gemm_s8_sm90(aq, xs, wq[:16], ws[2:18], bias[2:18],
                            out_f32=True)
    assert torch.equal(out, int8.gemm_s8_plain(aq, xs, wq[:16], ws[2:18],
                                               bias[2:18], out_f32=True))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,static", [(1, 64, False), (37, 2736, False),
                                           (37, 1024, True), (5, 258, False)])
def test_row_quant_kernel(dev, rows, n, static):
    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(rows, n, device=dev, generator=g) * 3).to(BF)
    sc = torch.tensor([0.05], device=dev) if static else None
    q, s = int8.row_quant(x, sc)
    qr, sr = (int8.statquant(x, sc) if static else int8.rowquant(x))
    assert torch.equal(s, sr.reshape(s.shape))
    assert torch.equal(q, qr)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,static,res", [
    (1, 64, False, False), (37, 1024, False, True), (37, 1024, True, False),
    (9, 2730, False, False), (9, 2730, True, True)])
def test_layernorm_int8_kernel(dev, rows, n, static, res):
    """The quantizing LayerNorm: the LN in f32 statistics may differ from
    the plain version's in the last bit, which can flip a bf16 rounding and
    with it an int8 step, so q may differ by one step in a few places."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = (torch.randn(rows, n, device=dev, generator=g) * 2).to(BF)
    r = (torch.randn(rows, n, device=dev, generator=g)).to(BF) if res \
        else None
    wgt = 1 + 0.1 * torch.randn(n, device=dev, generator=g)
    bias = 0.1 * torch.randn(n, device=dev, generator=g)
    sc = torch.tensor([0.04], device=dev) if static else None
    q, s = vit_block.layernorm_int8(x, wgt, bias, sc, r)
    qr, sr = vit_block.layernorm_int8_plain(x, wgt, bias, sc, r)
    torch.testing.assert_close(s, sr.reshape(s.shape), rtol=2 ** -7, atol=0)
    d = (q.int() - qr.int()).abs()
    assert d.max().item() <= 1 and d.float().mean().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 64), (2, 37, 64), (1, 300, 256)])
def test_int8_linear_kernel(dev, shape):
    """The head decoder's int8 linear: row quantization, int8 GEMM, the
    head's product order and bias rounding."""
    g = torch.Generator(device=dev).manual_seed(10)
    cin = shape[-1]
    x = torch.randn(*shape, device=dev, generator=g).to(BF)
    p = quantize_linear(torch.randn(96, cin, device=dev, generator=g) * 0.05,
                        torch.randn(96, device=dev, generator=g))
    out = _counted(int8.int8_linear, x, p)
    assert torch.equal(out, int8.int8_linear_plain(x, p))


# the five shapes of the head's int8 linears on the main path
# (ToC3D_faster_1600: 900 queries, 768 memory entries, 6 x 50 x 100 image
# tokens, width 256, FFN 2048): (rows, in, out)
H8_SHAPES = {"S1 q/o": (900, 256, 256), "S2 self k/v": (1668, 256, 256),
             "S3 cross k/v": (30000, 256, 256), "S4 ffn in": (900, 256, 2048),
             "S5 ffn out": (900, 2048, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(H8_SHAPES))
def test_int8_linear_kernel_main_shapes(dev, name):
    """Kernel H8 at each main-path shape, one launch a call: bit for bit the
    plain version and the old two launches (row quantization, then the
    mma.sync tile with the head's epilogue), on rows spanning three
    decades."""
    m, k, n = H8_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = (torch.randn(m, k, device=dev, generator=g)
         * torch.logspace(-2, 1, m, device=dev)[:, None]).to(BF)
    p = quantize_linear(torch.randn(n, k, device=dev, generator=g) * 0.05,
                        torch.randn(n, device=dev, generator=g))
    out = _counted(int8.int8_linear, x, p)
    assert torch.equal(out, int8.int8_linear_plain(x, p))
    q, s = int8.row_quant(x)
    assert torch.equal(out, int8.gemm_s8(q, s, p.w, p.scale, p.bias,
                                         head=True))
    nob = int8.QuantLinear(p.w, p.scale, None)
    assert torch.equal(int8.int8_linear(x, nob), int8.int8_linear_plain(x, nob))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(40, 64), (64, 60), (2064, 64), (8, 64)])
def test_int8_linear_refuses_what_it_does_not_take(dev, k, n):
    """in a multiple of 16 from 16 to 2048 and out a multiple of 8, or the
    wrapper raises before it launches: no route to the plain version or to
    the old tile."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn(5, k, device=dev, generator=g).to(BF)
    p = quantize_linear(torch.randn(n, k, device=dev, generator=g), None)
    before = int8.int8_linear.launches
    with pytest.raises(ValueError):
        int8.int8_linear(x, p)
    assert int8.int8_linear.launches == before


# ---------------------------------------------------------------------------
# the shapes of the other presets: ViT-B's width, ratio .7, 800x320 maps
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["B", "C", "B8", "C8", "B8 static",
                                  "C8 static"])
def test_vit_b_width_blocks(dev, kind):
    """ViT-B's block: width 768 in 12 heads of 64, SwiGLU hidden 2048 (no
    padding: the gate output and the sub-LN are exactly 2048 wide), on a
    20 x 50 map (800x320's patch grid) whose ws 16 windows reach past its
    edges."""
    c, heads, hidden, ws = 768, 12, 2048, 16
    blk = _block(c, heads, hidden, 7, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn(1, 20, 50, c, device=dev, generator=g) * 0.5).to(BF)
    scores = torch.randn(1, 1000, device=dev, generator=g).to(BF)
    tables = _rope(c, heads, ws, dev)
    int8_ = kind.startswith(("B8", "C8"))
    if kind.endswith("static"):
        _calibrate(blk, x, heads, ws, tables)
    wts = (vit_block.pack_block_weights_int8 if int8_ else
           vit_block.pack_block_weights)(blk, heads, BF)
    assert wts.hidden == wts.w3.shape[1] == hidden
    if kind.startswith("B"):
        fn = vit_block.fused_full_block_int8 if int8_ \
            else vit_block.fused_full_block
        out = _counted(fn, blk, x, heads, ws, tables)
        _close(out, vit_block.full_block_plain(wts, x, heads, ws, tables))
        plan = None
    else:
        fn = vit_block.fused_compressed_block_int8 if int8_ \
            else vit_block.fused_compressed_block
        out = _counted(fn, blk, x, scores, heads, ws, 0.7, tables, True,
                       True, True)
        plan = vit_block.compress_plan(scores, 1, 20, 50, ws, 0.7, True,
                                       True)
        assert plan.k == 179
        _close(out, vit_block.compressed_block_plain(wts, x, plan, heads,
                                                     ws, tables))
    _close(vit_block.attention_delta(blk, x, heads, ws, tables, plan,
                                     int8=int8_),
           vit_block.attention_delta_plain(wts, x, heads, ws, tables, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("ws,k", [(16, 179), (20, 280)])
@pytest.mark.parametrize("kind", ["C", "C8", "C8 static"])
def test_ratio_07_compressed_blocks(dev, ws, k, kind):
    """Ratio .7 (ToC3D_fast): k = int(n * .7) kept rows a window, 179 at ws
    16 and 280 at ws 20 (mxu_align_k leaves both), on a 20 x 50 map."""
    c, heads, hidden = 128, 2, 256
    blk = _block(c, heads, hidden, 8, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(2, 20, 50, c, device=dev, generator=g) * 0.5).to(BF)
    scores = torch.randn(2, 1000, device=dev, generator=g).to(BF)
    tables = _rope(c, heads, ws, dev)
    int8_ = kind != "C"
    if kind == "C8 static":
        _calibrate(blk, x, heads, ws, tables)
    plan = vit_block.compress_plan(scores, 2, 20, 50, ws, 0.7, True, True)
    assert plan.k == k
    fn = vit_block.fused_compressed_block_int8 if int8_ \
        else vit_block.fused_compressed_block
    out = _counted(fn, blk, x, scores, heads, ws, 0.7, tables, True, True,
                   True)
    wts = (vit_block.pack_block_weights_int8 if int8_ else
           vit_block.pack_block_weights)(blk, heads, BF)
    _close(out, vit_block.compressed_block_plain(wts, x, plan, heads, ws,
                                                 tables))
    _close(vit_block.attention_delta(blk, x, heads, ws, tables, plan,
                                     int8=int8_),
           vit_block.attention_delta_plain(wts, x, heads, ws, tables, plan))


# ---------------------------------------------------------------------------
# the captured frame (make_infer_fn on the card) against eager infer_step
# ---------------------------------------------------------------------------

RESET_STREAM = (0.0, 1.0, 1.0, 0.0, 1.0)


def _serving_model(quant, seed=3, backbone=None):
    """The tiny preset in bf16 on the card; quant 'static': backbone and
    decoder int8 with scales calibrated on 2 frames. backbone: fields to
    replace in the tiny backbone config, or "plain" for the plain EVA-02
    backbone of its widths."""
    from dataclasses import fields, replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector, synthetic_frame
    from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                                calibrate_act_scales)
    cfg = get_config("tiny", compute_dtype="bfloat16")
    cfg = replace(cfg, head=replace(cfg.head, compute_dtype="bfloat16"))
    if backbone == "plain":
        cfg = replace(cfg, backbone=EVAViTConfig(**{
            f.name: getattr(cfg.backbone, f.name)
            for f in fields(EVAViTConfig)}))
    elif backbone:
        cfg = replace(cfg, backbone=replace(cfg.backbone, **backbone))
    if quant != "none":
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    model = build_detector(cfg, device="cuda", seed=seed)
    if quant == "static":
        g = torch.Generator(device="cuda").manual_seed(5)
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(model, [
                synthetic_frame(g, t, views=2, height=64, width=128,
                                device="cuda") for t in range(2)]))
    return model


def _host_stream(prev=RESET_STREAM, seed=4):
    """Frames on the host in pinned memory, prev_exists as given."""
    from toc3d_tpu_torch.models.detector import synthetic_frame
    g = torch.Generator().manual_seed(seed)
    frames = []
    for t, pe in enumerate(prev):
        f = synthetic_frame(g, t, views=2, height=64, width=128,
                            device="cpu")
        f["prev_exists"] = torch.full((1,), pe)
        frames.append({k: v.pin_memory() for k, v in f.items()})
    return frames


def _outputs(out):
    state, det = out
    return tuple(state.memory) + tuple(det)


def _eager_stream(model, frames, mask_seed=0):
    from toc3d_tpu_torch.models.detector import eager_infer_fn, init_state
    infer = eager_infer_fn(model, mask_seed=mask_seed)
    state = init_state(1, model.cfg, device="cuda")
    outs = []
    for f in frames:
        state, det = infer(state, f)
        outs.append(_outputs((state, det)))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "static"])
def test_captured_frame_equals_eager(dev, quant):
    """make_infer_fn captures each program once, at its first use, and
    replays it from then on (frames 2-4: the backbone graphs of both steady
    values and the head graph), computing bit for bit what infer_step
    computes eagerly: the same kernels on the same inputs, no atomics, a
    stable sort. A frame's results are fresh tensors: replaying the next
    frame leaves them as they were."""
    from toc3d_tpu_torch.models.detector import init_state, make_infer_fn
    model = _serving_model(quant)
    frames = _host_stream()
    infer = make_infer_fn(model)
    state = init_state(1, model.cfg, device="cuda")
    got, held, captured = [], [], {}
    for t, f in enumerate(frames):
        state, det = infer(state, f)
        for name, prog in infer.runner.programs.items():
            assert captured.setdefault(name, prog) is prog, (t, name)
        outs = _outputs((state, det))
        torch.cuda.synchronize()
        for prev, copy in held:         # frame t-1's results, unchanged
            for a, b in zip(prev, copy):
                assert torch.equal(a, b), f"frame {t - 1} changed"
        held = [(outs, tuple(x.clone() for x in outs))]
        got.append(outs)
    assert sorted(map(str, infer.runner.programs)) == sorted(
        map(str, [("backbone+neck", False), ("backbone+neck", True),
                  "head+decode"]))
    for t, (a, b) in enumerate(zip(got, _eager_stream(model, frames))):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"frame {t}"


@pytest.mark.cuda
def test_captured_frame_counts_launches_per_replay(dev):
    """A replayed frame adds to each wrapper's count what an eager frame
    launches."""
    from toc3d_tpu_torch.models.detector import (infer_step, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    model = _serving_model("none")
    frames = _host_stream((0.0, 1.0, 1.0, 1.0))
    infer = make_infer_fn(model)
    state = init_state(1, model.cfg, device="cuda")
    for f in frames[:3]:
        state, _ = infer(state, f)
    counters = counted_wrappers()
    before = {k: c.launches for k, c in counters.items()}
    state, _ = infer(state, frames[3])
    replayed = {k: c.launches - before[k] for k, c in counters.items()}
    before = {k: c.launches for k, c in counters.items()}
    infer_step(model, state, frames[3])
    eager = {k: c.launches - before[k] for k, c in counters.items()}
    assert replayed == eager
    assert min(replayed[k] for k in ("A", "B", "C", "D")) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "dynamic"])
def test_captured_main_frame_counts_window_attention_bodies(dev, quant):
    """A replayed ToC3D_faster_1600 frame (6 views of 1600x800, random
    weights) runs the window attention's one-pass body 24 times (6 B and
    18 C) and the two-pass body never; with int8 blocks (dynamic) the
    reverse. Either way the QKV epilogue hands it q / k / v 24 times."""
    from dataclasses import replace
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn,
                                                 synthetic_frame)
    cfg = get_config("ToC3D_faster_1600")
    if quant != "none":
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    model = build_detector(cfg, device="cuda", seed=0)
    g = torch.Generator().manual_seed(9)
    frames = []
    for t in range(4):
        f = synthetic_frame(g, t, height=800, width=1600, device="cpu")
        f["prev_exists"] = torch.full((1,), float(t > 0))
        frames.append({k: v.pin_memory() for k, v in f.items()})
    infer = make_infer_fn(model)
    state = init_state(1, cfg, device="cuda")
    for f in frames[:3]:
        state, _ = infer(state, f)
    bodies = (vit_block.window_attention_one_pass,
              vit_block.window_attention_two_pass,
              vit_block.qkv_rope_epilogue)
    before = [b.launches for b in bodies]
    infer(state, frames[3])
    torch.cuda.synchronize()
    assert [b.launches - n for b, n in zip(bodies, before)] == \
        ([24, 0, 24] if quant == "none" else [0, 24, 24])


@pytest.mark.cuda
def test_captured_frame_recaptures_after_load_state_dict(dev):
    """New weights change the weight key: the programs are packed and
    captured again, and then equal eager infer_step under the new
    weights."""
    from toc3d_tpu_torch.models.detector import init_state, make_infer_fn
    model = _serving_model("none")
    frames = _host_stream()
    infer = make_infer_fn(model)
    state = init_state(1, model.cfg, device="cuda")
    for f in frames[:3]:
        state, _ = infer(state, f)
    old = infer.runner.programs["head+decode"]
    model.load_state_dict(_serving_model("none", seed=8).state_dict())
    state = init_state(1, model.cfg, device="cuda")
    got = []
    for f in frames:
        state, det = infer(state, f)
        got.append(_outputs((state, det)))
    assert infer.runner.programs["head+decode"] is not old
    for t, (a, b) in enumerate(zip(got, _eager_stream(model, frames))):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"frame {t}"


@pytest.mark.cuda
def test_failed_capture_raises(dev):
    """A capture that fails (here: a device synchronisation on the path)
    raises; make_infer_fn never carries on eagerly. Run in a process of its
    own, so the failed capture touches no other test."""
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_cuda import _serving_model, _host_stream\n"
        "from toc3d_tpu_torch.models import detector as td\n"
        "decode = td.nms_free_decode\n"
        "def syncing(*a, **kw):\n"
        "    torch.cuda.synchronize()\n"
        "    return decode(*a, **kw)\n"
        "td.nms_free_decode = syncing\n"
        "model = _serving_model('none')\n"
        "infer = td.make_infer_fn(model)\n"
        "state = td.init_state(1, model.cfg, device='cuda')\n"
        "try:\n"
        "    infer(state, _host_stream()[0])\n"
        "except RuntimeError as e:\n"
        "    print('raised', type(e).__name__)\n"
        "    sys.exit(0)\n"
        "sys.exit('no error: the capture was not made to fail')\n")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "raised" in r.stdout


@pytest.mark.cuda
def test_plain_backbone_frame_captured_once_equals_eager(dev):
    """The StreamPETR form (plain EVA-02 backbone, no selectors): one
    backbone program, whatever prev_exists says, and one head program, each
    captured once; bit for bit eager's over a stream with a reset."""
    from toc3d_tpu_torch.models.detector import init_state, make_infer_fn
    from toc3d_tpu_torch.models.eva_vit import EVAViT
    model = _serving_model("none", backbone="plain")
    assert type(model.img_backbone) is EVAViT and not model.cfg.is_toc3d
    frames = _host_stream()
    infer = make_infer_fn(model)
    state = init_state(1, model.cfg, device="cuda")
    got, captured = [], {}
    for t, f in enumerate(frames):
        state, det = infer(state, f)
        for name, prog in infer.runner.programs.items():
            assert captured.setdefault(name, prog) is prog, (t, name)
        got.append(_outputs((state, det)))
    assert sorted(map(str, infer.runner.programs)) == sorted(
        map(str, [("backbone+neck",), "head+decode"]))
    for t, (a, b) in enumerate(zip(got, _eager_stream(model, frames))):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"frame {t}"


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "dynamic", "static"])
def test_loaded_export_captured_equals_eager_and_make_infer_fn(dev, tmp_path,
                                                              quant):
    """The loaded artifact (runtime/export.load_detector) on the card: its
    call replays its programs as captured CUDA graphs (backbone_first,
    backbone_steady and head, each captured once), its eager run launches
    them op by op, and both equal make_infer_fn bit for bit over a stream
    with a reset, in bf16 and int8 (dynamic, static) on uint8 frames. A
    replayed frame launches what an eager frame launches."""
    from toc3d_tpu_torch.models.detector import init_state, make_infer_fn
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    from toc3d_tpu_torch.runtime.export import export_detector, load_detector
    model = _serving_model(quant)
    export_detector(model, str(tmp_path), batch_size=1, num_views=2,
                    img_dtype=torch.uint8)
    det = load_detector(str(tmp_path))
    frames = _host_stream()
    ref = make_infer_fn(model)
    s_ref = init_state(1, model.cfg, device="cuda")
    s_cap, s_eag, captured = det.init_state(), det.init_state(), {}
    for t, f in enumerate(frames):
        s_ref, d_ref = ref(s_ref, f)
        s_cap, d_cap = det(s_cap, f)
        s_eag, d_eag = det.eager(s_eag, f)
        for name, prog in det.runner.programs.items():
            assert captured.setdefault(name, prog) is prog, (t, name)
        want = _outputs((s_ref, d_ref))
        for run, got in (("captured", _outputs((s_cap, d_cap))),
                         ("eager", _outputs((s_eag, d_eag)))):
            for x, y in zip(got, want):
                assert torch.equal(x, y), f"{run}, frame {t}"
    assert sorted(det.runner.programs) == ["backbone_first",
                                           "backbone_steady", "head+decode"]
    counters = counted_wrappers()
    before = {k: c.launches for k, c in counters.items()}
    det(s_cap, frames[-1])
    replayed = {k: c.launches - before[k] for k, c in counters.items()}
    before = {k: c.launches for k, c in counters.items()}
    det.eager(s_eag, frames[-1])
    eager = {k: c.launches - before[k] for k, c in counters.items()}
    assert replayed == eager
    assert replayed["A"] > 0 and replayed["D"] > 0


# two selectors, so the first one's mask shapes the second one's scores
GUMBEL = dict(eval_mask="gumbel", pruning_loc=(0, 2), token_ratio=(0.5, 0.5))


@pytest.mark.cuda
def test_gumbel_replays_draw_fresh_noise_and_equal_eager(dev):
    """eval_mask 'gumbel' captured: every call draws its frame's noise from
    (mask_seed, frame) into the graphs' static buffers, so the captured
    stream equals eager infer_step from the same mask_seed bit for bit,
    and two replays on the same state and frame give different results
    (fresh noise) while the global generator is left alone."""
    from toc3d_tpu_torch.models.detector import init_state, make_infer_fn
    model = _serving_model("none", backbone=GUMBEL)
    frames = _host_stream()
    infer = make_infer_fn(model, mask_seed=11)
    state = init_state(1, model.cfg, device="cuda")
    got = []
    for f in frames:
        state, det = infer(state, f)
        got.append(_outputs((state, det)))
    for t, (a, b) in enumerate(zip(got, _eager_stream(model, frames, 11))):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"frame {t}"
    other = _eager_stream(model, frames, 12)
    assert not all(torch.equal(x, y) for x, y in zip(got[1], other[1]))
    rng = torch.cuda.get_rng_state()
    first = _outputs(infer(state, frames[-1]))
    again = _outputs(infer(state, frames[-1]))
    assert infer.noise.counter == len(frames) + 2
    assert not torch.equal(first[0], again[0])     # the bank's embeddings
    assert torch.equal(rng, torch.cuda.get_rng_state())


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_streaming_eval_captured_equals_eager(dev, tmp_path, fast):
    """streaming_eval over two synthetic scenes (90x160 JPEGs resized to
    the tiny preset's 64x128, 2 views), through the captured frame and
    through eager infer_step, writes the same submission bytes; fast:
    uint8 frames normalized on the card (fast decode), else float32
    frames normalized on the host. The memory resets at the second scene
    through the host prev_exists, which picks the backbone graph."""
    from toc3d_tpu_torch.data.loader import build_eval_frame
    from toc3d_tpu_torch.data.nuscenes import AugConfig, NuScenesInfos
    from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
    from toc3d_tpu_torch.models.detector import (eager_infer_fn, init_state,
                                                 make_infer_fn)
    from toc3d_tpu_torch.runtime.eval import streaming_eval, write_submission
    model = _serving_model("none")
    infos = NuScenesInfos(make_learnable_dataset(
        str(tmp_path / "data"), n_scenes=2, frames_per_scene=3, n_cams=2,
        src_h=90, src_w=160))
    aug = AugConfig(final_dim=model.cfg.pad_shape, H=90, W=160,
                    rand_flip=False)
    pairs = [build_eval_frame(infos, i, aug, fast_decode=fast,
                              device_normalize=fast)
             for i in range(len(infos))]
    assert pairs[0][0]["img"].dtype == (np.uint8 if fast else np.float32)
    frames, metas = [p[0] for p in pairs], [p[1] for p in pairs]
    subs = []
    for name, infer in (("captured", make_infer_fn(model)),
                        ("eager", eager_infer_fn(model))):
        res = streaming_eval(infer, lambda: init_state(1, model.cfg,
                                                       device="cuda"),
                             frames, metas)
        assert list(res) == [m["token"] for m in metas]
        with open(write_submission(res, str(tmp_path / name)), "rb") as f:
            subs.append(f.read())
    assert subs[0] == subs[1]


@pytest.mark.cuda
def test_infer_step_with_aux_equals_infer_step(dev):
    """The token visualizer's step (the collected forward) computes what
    infer_step computes, bit for bit, and returns one (B*N, h, w, 1) mask
    per selector."""
    from toc3d_tpu_torch.models.detector import (infer_step,
                                                 infer_step_with_aux,
                                                 init_state,
                                                 precast_backbone_)
    model = _serving_model("none")
    precast_backbone_(model)
    plain = aux_state = init_state(1, model.cfg, device="cuda")
    cfg = model.cfg.backbone
    for f in _host_stream((0.0, 1.0, 1.0)):
        plain, det = infer_step(model, plain, f)
        aux_state, aux_det, aux = infer_step_with_aux(model, aux_state, f)
        for a, b in zip(_outputs((plain, det)), _outputs((aux_state,
                                                          aux_det))):
            assert torch.equal(a, b)
        h, w = (s // cfg.patch_size for s in model.cfg.pad_shape)
        assert [tuple(m.shape) for m in aux["token_masks"]] == \
            [(f["img"].shape[1], h, w, 1)] * len(cfg.pruning_loc)


# ---------------------------------------------------------------------------
# StreamPETR V2-99: VoVNet-99-eSE and the two-level CPFPN in the captured
# frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v299():
    """stream_petr_vov_flash_800_bs2_seq_24e on the card with seeded random
    weights behind make_infer_fn, and 4 pinned host frames of 6 views at
    800x320 (a scene start, then steady)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector,
                                                 make_infer_fn,
                                                 synthetic_frame)
    cfg = get_config("stream_petr_vov_flash_800_bs2_seq_24e")
    model = build_detector(cfg, device="cuda", seed=0)
    g = torch.Generator().manual_seed(0)
    frames = [{k: v.pin_memory() for k, v in synthetic_frame(
        g, t, height=320, width=800, device="cpu").items()}
        for t in range(4)]
    return model, make_infer_fn(model), frames


@pytest.mark.cuda
def test_v299_captured_frame_equals_eager(v299):
    """Each frame through the captured graphs equals eager infer_step on
    the same weights and bank, bit for bit: boxes, scores, labels and the
    bank."""
    from toc3d_tpu_torch.models.detector import infer_step, init_state
    model, infer, frames = v299
    s_cap = init_state(1, model.cfg, device="cuda")
    s_eag = init_state(1, model.cfg, device="cuda")
    for t, f in enumerate(frames):
        s_cap, d_cap = infer(s_cap, f)
        s_eag, d_eag = infer_step(model, s_eag, f)
        for a, b in zip(_outputs((s_cap, d_cap)), _outputs((s_eag, d_eag))):
            assert torch.equal(a, b), t


@pytest.mark.cuda
def test_v299_frame_counts_106_convolutions(v299):
    """A replayed V2-99 frame, and an eager one, launch the encoder's 106
    convolutions (3 stem, 16 blocks x 6, 4 eSE, 3 in the neck) through the
    packed-convolution wrapper and kernel D 12 times (6 layers x self and
    cross), and none of the ViT's kernels (the QKV epilogue 0 times)."""
    from toc3d_tpu_torch.models.detector import infer_step, init_state
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    model, infer, frames = v299
    state = init_state(1, model.cfg, device="cuda")
    for f in frames[:3]:
        state, _ = infer(state, f)
    counters = counted_wrappers()
    for run in (infer, lambda s, f: infer_step(model, s, f)):
        before = {k: c.launches for k, c in counters.items()}
        state, _ = run(state, frames[3])
        got = {k: c.launches - before[k] for k, c in counters.items()}
        assert got["conv"] == 106
        assert got["D"] == 12
        assert got["qkv"] == 0
        assert sum(got.values()) == 118


@pytest.mark.cuda
def test_v299_replay_casts_no_weight_and_transposes_no_layout(v299):
    """The replayed backbone+neck program holds no layout transpose of
    cuDNN's (nchwToNhwc / nhwcToNchw) and one f32 -> bf16 cast, the image's:
    no weight is cast (the per-call casts would add one a convolution). An
    eager backbone+neck reads every parameter and buffer of the encoder
    only through its packs: no copy, cast or arithmetic takes one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from toc3d_tpu_torch.models.detector import extract_img_feat, init_state
    model, infer, frames = v299
    state = init_state(1, model.cfg, device="cuda")
    for f in frames[:2]:
        state, _ = infer(state, f)
    (prog,) = [p for k, p in infer.runner.programs.items()
               if k[0] == "backbone+neck"]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prog.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) > 106
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]
    assert sum("bfloat16_copy_kernel" in n for n in names) == 1
    encoder = {t.data_ptr() for m in (model.img_backbone, model.img_neck)
               for t in list(m.parameters()) + list(m.buffers())}
    read = []

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for a in list(args) + list((kwargs or {}).values()):
                if isinstance(a, torch.Tensor) and a.data_ptr() in encoder:
                    read.append(str(func))
            return func(*args, **(kwargs or {}))
    f = {k: v.cuda() for k, v in frames[3].items()}
    with torch.no_grad(), Reads():
        extract_img_feat(model, f["img"], state.memory, f, steady=True)
    assert read == []
