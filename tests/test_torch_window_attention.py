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
"""
import pytest
import torch

from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
from toc3d_tpu_torch.ops.cuda import vit_block
from toc3d_tpu_torch.ops.rope import build_rope_table

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
    out: records (C entry point, arguments)."""
    calls = []
    monkeypatch.setattr(vit_block, "call",
                        lambda lib, fn, *a: calls.append((fn, a)))
    monkeypatch.setattr(vit_block, "stream_of", lambda t: 0)
    monkeypatch.setattr(vit_block, "window_attention_slots", lambda d: 9)
    monkeypatch.setattr(vit_block, "_ln_in", lambda *a, **kw: None)
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
