"""The port's int8 serving path (toc3d_tpu_torch: int8 packs, the B8 / C8
plain versions, the head decoder's int8 linears, static calibration) against
the JAX package on the CPU in f32.

On the CPU every int8 wrapper runs its plain version; these tests hold that
version to the JAX int8 math (the Pallas int8 bodies in interpret mode, or
XLA), and chip_smoke.py / tests/test_torch_cuda.py hold the CUDA kernels to
it on the card.

Tolerances. Weight packs and calibrated scales come from the same f32
arithmetic and are compared exactly (scales within 1e-5 relative). Block
outputs: the int8 product is exact on both sides, but an f32 ulp in an
activation can move a value across a .5 rounding boundary of its int8
step, so the outputs are compared in mean relative error (<= 1e-3) and in
max abs error (<= 2% of max |JAX|). Measured worst here, no flip: B8 4e-8
mean / 1.2e-7 max, C8 6.7e-8 / 1.6e-7, attention deltas 3.8e-7 / 9e-7.
The streamed slice meets flips; see test_port_int8_streaming_matches_jax.
"""
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.core.coder import nms_free_decode as jax_decode
from toc3d_tpu.layers import quantize_linear as jax_quantize_linear
from toc3d_tpu.models import eva_vit as jax_eva_vit
from toc3d_tpu.models import toc3d_vit as jax_toc3d_vit
from toc3d_tpu.models.detector import _precast_backbone_params
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.models.petr_transformer import (DecoderConfig as JDecCfg,
                                               decoder_forward as jax_decoder,
                                               init_decoder,
                                               quantize_decoder_params as
                                               jax_quantize_decoder)
from toc3d_tpu.models.toc3d_vit import ToC3DViTConfig as JToC3DCfg
from toc3d_tpu.ops import int8_calib as jax_calib
from toc3d_tpu.ops.pallas.vit_block import (_ACT_SITES,
                                            fused_compressed_block as
                                            jax_compressed,
                                            fused_full_block as jax_full,
                                            quantize_block_params)
from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint

from test_full_converter import build_reference_state_dict
from test_parity_detector import make_frames
from test_torch_kernels import _jax_block, _tables, _torch_block

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.convert import _Out, params_from_jax
from toc3d_tpu_torch.layers import quantize_linear
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.models.eva_vit import set_act_scales
from toc3d_tpu_torch.models.petr_transformer import (Decoder, DecoderConfig,
                                                     decoder_forward,
                                                     quantize_decoder_params)
from toc3d_tpu_torch.ops import int8_calib
from toc3d_tpu_torch.ops.attention import quantize_mha
from toc3d_tpu_torch.ops.cuda import vit_block as tvb
from toc3d_tpu_torch.ops.cuda.int8 import SITES

F32 = torch.float32


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _mean_rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).mean() / np.abs(ref).mean()


def _close_int8(out, ref, mean_tol=1e-3):
    """Mean relative error within mean_tol, and no element off by more
    than a few int8 steps of the output's magnitude (2% of max |ref|)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _mean_rel(out, ref) <= mean_tol, _mean_rel(out, ref)
    assert np.abs(out - ref).max() <= 0.02 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# weight packs
# ---------------------------------------------------------------------------

def test_block_int8_pack_equals_quantize_block_params():
    c, hidden, heads = 32, 64, 2
    p = _jax_block(0, c, hidden)
    pq = jax.tree_util.tree_map(np.asarray, quantize_block_params(p, heads))
    wts = tvb.pack_block_weights_int8(_torch_block(p, c, hidden), heads, F32)
    a, m = pq["attn"], pq["mlp"]
    eq = np.testing.assert_array_equal
    eq(_np(wts.wqkv), np.concatenate([a[k]["w"].T for k in
                                      ("q_proj", "k_proj", "v_proj")]))
    eq(_np(wts.sqkv), np.concatenate([a[k]["w_scale"] for k in
                                      ("q_proj", "k_proj", "v_proj")]))
    eq(_np(wts.wo), a["proj"]["w"].T)
    eq(_np(wts.so), a["proj"]["w_scale"])
    eq(_np(wts.w12[0:2 * hidden:2]), m["w1"]["w"].T)
    eq(_np(wts.w12[1:2 * hidden:2]), m["w2"]["w"].T)
    eq(_np(wts.s12[0:2 * hidden:2]), m["w1"]["w_scale"])
    eq(_np(wts.s12[1:2 * hidden:2]), m["w2"]["w_scale"])
    eq(_np(wts.w3[:, :hidden]), m["w3"]["w"].T)
    eq(_np(wts.s3), m["w3"]["w_scale"])
    assert wts.wqkv.dtype == torch.int8
    assert tvb.is_quantized(wts) == "dynamic"
    assert not tvb.is_quantized(tvb.pack_block_weights(
        _torch_block(p, c, hidden), heads, F32))


def test_quantize_linear_equals_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(48, 80) * 0.05).astype(np.float32)     # (in, out)
    b = rng.randn(80).astype(np.float32)
    jq = jax_quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tq = quantize_linear(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(tq.w), np.asarray(jq["w"]).T)
    np.testing.assert_array_equal(_np(tq.scale), np.asarray(jq["w_scale"]))
    np.testing.assert_array_equal(_np(tq.bias), b)


@pytest.mark.parametrize("scale,k", [(1.0, 96), (1e-3, 96), (40.0, 2736)])
def test_quant_primitives_bit_equal_jax(scale, k):
    """The quantization arithmetic, bit for bit: per-row (_rowquant: a
    multiply by 127 / amax) and static (_statquant: a multiply by 1 / s)
    activation quantization, the dequantized product _qmm, and the head's
    _int8_matmul, on the same f32 inputs (rows spanning 6 decades). At
    k = 2736 (the ViT-L hidden width, padded) row 0 meets 20 columns of
    64..127 with its own signs: sums near 127 * 96 * 2736 = 3.3e7, past
    f32's exact integers (2^24)."""
    from toc3d_tpu.layers import _int8_matmul as jax_int8_matmul
    from toc3d_tpu.ops.pallas import vit_block as jvb
    from toc3d_tpu_torch.ops.cuda import int8
    rng = np.random.RandomState(3)
    x = (rng.randn(64, k) * scale
         * np.logspace(-3, 3, 64)[:, None]).astype(np.float32)
    w = rng.randint(-127, 128, (k, 40)).astype(np.int8)      # (in, out)
    sign = np.where(x[0] >= 0, 1, -1)
    w[:, :20] = sign[:, None] * rng.randint(64, 128, (k, 20))
    x[0] = sign * scale
    ws = (rng.rand(40) * 1e-2).astype(np.float32)
    eq = np.testing.assert_array_equal
    jq, js = jvb._rowquant(jnp.asarray(x))
    tq, ts = int8.rowquant(torch.from_numpy(x))
    eq(_np(tq), np.asarray(jq))
    eq(_np(ts), np.asarray(js))
    st = np.float32(np.abs(x).max() / 127 / 3)        # saturates the tails
    jq2, _ = jvb._statquant(jnp.asarray(x), jnp.full((1, 1), st))
    tq2, _ = int8.statquant(torch.from_numpy(x), torch.tensor([st]))
    eq(_np(tq2), np.asarray(jq2))
    eq(_np(tvb._qmm(tq, ts, torch.from_numpy(w.T.copy()),
                    torch.from_numpy(ws))),
       np.asarray(jvb._qmm(jq, js, jnp.asarray(w), jnp.asarray(ws))))
    eq(_np(int8.int8_matmul(torch.from_numpy(x),
                            torch.from_numpy(w.T.copy()),
                            torch.from_numpy(ws))),
       np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(ws))))


def _decoder_pair(seed):
    """JAX decoder params (test_int8_head.py:31-55 shapes) and the port's
    Decoder with the same weights, quant int8 on both."""
    jcfg = JDecCfg(embed_dims=64, num_heads=4, num_layers=2,
                   feedforward_channels=128, dropout=0.0, quant="int8")
    p = jax.jit(lambda k: init_decoder(k, jcfg))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    # non-zero biases, so that the head's bias rounding is exercised
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.randn(*a.shape).astype(np.float32)
                                   * 0.05 if a.ndim == 1 else 0), p)
    o = _Out()
    for i, lp in enumerate(p["layers"]):
        o.mha(f"layers.{i}.attentions.0.attn", lp["self_attn"])
        o.mha(f"layers.{i}.attentions.1.attn", lp["cross_attn"])
        o.linear(f"layers.{i}.ffns.0.layers.0.0", lp["ffn"]["fc0"])
        o.linear(f"layers.{i}.ffns.0.layers.1", lp["ffn"]["fc1"])
        for j in range(3):
            o.ln(f"layers.{i}.norms.{j}", lp[f"norm{j}"])
    o.ln("post_norm", p["post_norm"])
    tcfg = DecoderConfig(embed_dims=64, num_heads=4, num_layers=2,
                         feedforward_channels=128, dropout=0.0, quant="int8")
    dec = Decoder(tcfg)
    dec.load_state_dict(o.sd)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, p), tcfg, dec.eval()


def test_quantize_decoder_params_equals_jax():
    _, p, _, dec = _decoder_pair(0)
    pq = jax_quantize_decoder(p)
    quantize_decoder_params(dec)
    for lp, layer in zip(pq["layers"], dec.layers):
        for name, att in (("self_attn", layer.attentions[0].attn),
                          ("cross_attn", layer.attentions[1].attn)):
            for k, tq in zip(("q_proj", "k_proj", "v_proj", "out_proj"),
                             quantize_mha(att)):
                np.testing.assert_array_equal(
                    _np(tq.w), np.asarray(lp[name][k]["w"]).T)
                np.testing.assert_array_equal(
                    _np(tq.scale), np.asarray(lp[name][k]["w_scale"]))


def test_int8_decoder_matches_jax():
    """The decoder with int8 linears against JAX decoder_forward on
    quantize_decoder_params weights: both quantize each row the same way
    and sum int8 products exactly, so they agree to f32 rounding (measured
    max |d| ~1e-6)."""
    jcfg, p, tcfg, dec = _decoder_pair(1)
    rng = np.random.RandomState(1)
    b, q, kv = 2, 12, 40
    tgt = rng.randn(b, q, 64).astype(np.float32)
    mem = rng.randn(b, kv, 64).astype(np.float32)
    qpos = (rng.randn(b, q, 64) * 0.1).astype(np.float32)
    kpos = (rng.randn(b, kv, 64) * 0.1).astype(np.float32)
    ref, _ = jax.jit(lambda p_, *a: jax_decoder(p_, jcfg, *a, None))(
        jax_quantize_decoder(p), jnp.asarray(tgt), jnp.asarray(mem),
        jnp.asarray(qpos), jnp.asarray(kpos))
    T = torch.from_numpy
    with torch.no_grad():
        out = decoder_forward(dec, tcfg, T(tgt), T(mem), T(qpos), T(kpos))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-4)


# ---------------------------------------------------------------------------
# B8 / C8 plain versions against the Pallas int8 bodies (interpret mode)
# ---------------------------------------------------------------------------

def _static_scales(probe, *args):
    """Site scales amax / 127 from a JAX int8_calib probe, run under jit."""
    amax = jax.jit(probe)(*args)
    return {k: float(amax[k]) / 127.0 for k in _ACT_SITES}


def _jax_full(pq, x, heads, ws, tables):
    """JAX fused_full_block in interpret mode, under jit (3x faster than
    eager interpretation of the grid)."""
    return jax.jit(lambda p_, x_: jax_full(p_, x_, heads, ws, tables,
                                           interpret=True))(pq, x)


def _jax_compressed(pq, x, scores, heads, ws, ratio, tables, align):
    return jax.jit(lambda p_, x_, s_: jax_compressed(
        p_, x_, s_, heads, ws, ratio, tables, use_represent=True,
        rope_acc=True, interpret=True, align_k=align))(pq, x, scores)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("ws,hw", [(8, (10, 12)), (4, (8, 12))])
def test_full_block_int8_plain_matches_pallas(ws, hw, static):
    """test_pallas.py:342 shapes: ws 8 on 10 x 12 (edge pads, image
    layout) and ws 4 on 8 x 12 (stripe layout)."""
    c, hidden, heads = 32, 64, 2
    p = _jax_block(6, c, hidden)
    blk = _torch_block(p, c, hidden)
    rng = np.random.RandomState(11)
    x = rng.randn(2, *hw, c).astype(np.float32)
    jt, tt = _tables(c, heads, ws)
    scales = None
    if static:
        scales = _static_scales(
            lambda p_, x_: jax_calib.full_block_site_amax(p_, x_, heads, ws,
                                                          jt),
            p, jnp.asarray(x))
        set_act_scales(blk, scales)
    pq = quantize_block_params(p, heads, act_scales=scales)
    ref = _jax_full(pq, jnp.asarray(x), heads, ws, jt)
    out = tvb.fused_full_block_int8(blk, torch.from_numpy(x), heads, ws, tt)
    _close_int8(out, ref)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("ws,hw,c,ratio,align", [
    (8, (10, 12), 32, 0.5, True),
    (4, (8, 12), 32, 0.5, True),
    (16, (20, 20), 64, 0.5, True),           # k = 127 + representative
])
def test_compressed_block_int8_plain_matches_pallas(ws, hw, c, ratio, align,
                                                    static):
    hidden, heads = 2 * c, 2
    p = _jax_block(7, c, hidden)
    blk = _torch_block(p, c, hidden)
    rng = np.random.RandomState(12)
    x = rng.randn(2, *hw, c).astype(np.float32)
    scores = rng.randn(2, hw[0] * hw[1]).astype(np.float32)
    jt, tt = _tables(c, heads, ws)
    scales = None
    if static:
        tcfg = JToC3DCfg(embed_dim=c, num_heads=heads, mlp_ratio=2.0,
                         window_size=ws, pruning_loc=(0,),
                         token_ratio=(ratio,), global_attn_indexes=(9,),
                         use_represent_tokens=True, rope_acc=True,
                         mxu_align_k=align)
        scales = _static_scales(
            lambda p_, x_, s_: jax_calib.compressed_block_site_amax(
                p_, x_, s_, tcfg, ws, ratio, jt),
            p, jnp.asarray(x), jnp.asarray(scores))
        set_act_scales(blk, scales)
    pq = quantize_block_params(p, heads, act_scales=scales)
    ref = _jax_compressed(pq, jnp.asarray(x), jnp.asarray(scores), heads, ws,
                          ratio, jt, align)
    out = tvb.fused_compressed_block_int8(
        blk, torch.from_numpy(x), torch.from_numpy(scores), heads, ws, ratio,
        tt, use_represent=True, rope_acc=True, align_k=align)
    _close_int8(out, ref)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
def test_attention_delta_int8_plain_matches_pallas(compressed, static):
    """The attention delta alone: with w3 and b3 zeroed the JAX block
    returns x + raw1 exactly (the MLP delta is 0), so out - x is JAX's
    int8 attention delta, held against attention_delta_plain."""
    c, hidden, heads, ws = 32, 64, 2, 4
    p = _jax_block(8, c, hidden)
    p["mlp"]["w3"] = {"w": jnp.zeros_like(p["mlp"]["w3"]["w"]),
                      "b": jnp.zeros_like(p["mlp"]["w3"]["b"])}
    blk = _torch_block(p, c, hidden)
    rng = np.random.RandomState(13)
    h, w = 7, 10
    x = rng.randn(2, h, w, c).astype(np.float32)
    scores = rng.randn(2, h * w).astype(np.float32)
    jt, tt = _tables(c, heads, ws)
    scales = None
    if static:
        scales = _static_scales(
            lambda p_, x_: jax_calib.full_block_site_amax(p_, x_, heads, ws,
                                                          jt),
            p, jnp.asarray(x))
        set_act_scales(blk, scales)
    pq = quantize_block_params(p, heads, act_scales=scales)
    X = torch.from_numpy(x)
    if not compressed:
        ref = np.asarray(_jax_full(pq, jnp.asarray(x), heads, ws, jt)) - x
        out = tvb.attention_delta(blk, X, heads, ws, tt, int8=True)
    else:
        out_j = np.asarray(_jax_compressed(
            pq, jnp.asarray(x), jnp.asarray(scores), heads, ws, 0.5, jt,
            True))
        plan = tvb.compress_plan(torch.from_numpy(scores), 2, h, w, ws, 0.5,
                                 True, True)
        rows = tvb.attention_delta(blk, X, heads, ws, tt, plan, int8=True)
        # the slow rows of the JAX output are x + raw1 at the kept tokens
        from toc3d_tpu_torch.ops.window import window_partition
        xw, _ = window_partition(torch.from_numpy(out_j - x), ws)
        xw = xw.reshape(xw.shape[0], ws * ws, c)
        idx = plan.slow_idx[..., None]
        ref = torch.gather(xw, 1, idx.expand(-1, -1, c))
        # kept edge pads (-1e6 scores, chosen last) are dropped by both
        valid, _ = window_partition(torch.ones(2, h, w, 1), ws)
        valid = torch.gather(valid.reshape(-1, ws * ws, 1), 1, idx)
        out, ref = rows[:, :plan.k] * valid, ref * valid
    _close_int8(out, ref)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _tiny_pair(seed, quant=False):
    jcfg = jax_get_config("tiny")
    tcfg = get_config("tiny")
    if quant:
        jcfg = replace(jcfg, backbone=replace(jcfg.backbone, quant="int8",
                                              fused_blocks=True),
                       head=replace(jcfg.head, decoder=replace(
                           jcfg.head.decoder, quant="int8")))
        tcfg = replace(tcfg, backbone=replace(tcfg.backbone, quant="int8"),
                       head=replace(tcfg.head, decoder=replace(
                           tcfg.head.decoder, quant="int8")))
    rng = np.random.RandomState(seed)
    sd = build_reference_state_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    return jcfg, tcfg, rng, sd, params


def test_calibrate_act_scales_matches_jax():
    """tiny preset, f32, 2 frames (test_pallas.py:431-473 drives the JAX
    side): every block and site within 1e-5 relative; then the JAX-attached
    scales, carried by params_from_jax, land on the port's blocks and its
    static int8 packs."""
    jcfg, tcfg, rng, sd, params = _tiny_pair(21)
    frames = make_frames(rng, jcfg, t_total=2)
    ref = jax_calib.calibrate_act_scales(
        params, jcfg, [{k: jnp.asarray(v) for k, v in f.items()}
                       for f in frames])
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    got = int8_calib.calibrate_act_scales(
        model, [td.frame_to_device(f, "cpu") for f in frames])
    assert len(got) == len(ref) == tcfg.backbone.depth
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in SITES:
            np.testing.assert_allclose(g[k], float(r[k]), rtol=1e-5,
                                       err_msg=f"block {i} {k}")

    attached = jax_calib.attach_act_scales(params, ref)
    sd2 = params_from_jax(jax.tree_util.tree_map(np.asarray, attached), jcfg)
    qcfg = replace(tcfg, backbone=replace(tcfg.backbone, quant="int8"))
    model2 = td.build_detector(qcfg, device="cpu", state_dict=sd2)
    for i, blk in enumerate(model2.img_backbone.blocks):
        want = np.array([float(ref[i][k]) for k in SITES], np.float32)
        np.testing.assert_array_equal(_np(blk.act_scales), want)
        wts = tvb.pack_block_weights_int8(blk, qcfg.backbone.num_heads, F32)
        assert tvb.is_quantized(wts) == "static"
        np.testing.assert_array_equal(_np(wts.act), want)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

class _TPUBackend:
    """Proxy of the jax module whose default_backend() says 'tpu', so that
    the JAX detector takes its fused-kernel block path (the XLA block path
    rejects int8 params); the kernels read the real backend in their own
    modules and run in interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _rows_matched(t_rows, j_rows, tol):
    """How many rows of t_rows (R, D) pair one-to-one with a row of j_rows
    within tol (max abs, relative to 1 + the JAX row's max abs)."""
    from scipy.optimize import linear_sum_assignment
    cost = (np.abs(t_rows[:, None] - j_rows[None]).max(-1)
            / (1 + np.abs(j_rows).max(-1)))
    r, c = linear_sum_assignment(cost)
    return int((cost[r, c] <= tol).sum())


@pytest.mark.parametrize("static", [False, True])
def test_port_int8_streaming_matches_jax(static, monkeypatch):
    """tiny preset, backbone and decoder int8, 3 streamed frames
    (prev_exists 0, 1, 1), against JAX extract_img_feat / head_forward (the
    two halves of infer_step) on _precast_backbone_params params; static:
    JAX-calibrated scales carried to the port by params_from_jax.

    An f32 ulp that moves one activation across a .5 boundary of its int8
    step changes that value by a whole step. The random-weight scores are
    nearly tied (the 16 decoded lie within 3e-4, and so do the selectors'
    token scores), so such a flip can reorder them, and the top-k choices
    (token routing, decoded boxes, the queries that enter the memory bank)
    then differ in a few places, and the streams would part from there. So
    each frame starts the port from JAX's memory bank, and:
    * neck features: mean relative error <= 1e-3 (_close_int8; measured
      ~2.6e-7 in five of the six frames, 3.6e-4 in frame 2 of the static
      run, where a flip moved the routing);
    * every query's class scores and boxes, all decoder layers: mean
      relative error <= 2e-3 (measured 4e-7 without a flip, 5.8e-5 after
      one in the head, 1.09e-3 in static frame 2);
    * the decoded scores as sorted lists, 1e-3;
    * the new memory bank as a set of rows (embedding, reference point,
      velocity), paired one to one: at most topk_proposals (8, the rows
      this frame adds) of its 32 rows unmatched within 1e-3 (measured: 0
      in four frames, 1 and 6 in static frames 1 and 2)."""
    from toc3d_tpu.models.detector import extract_img_feat as jax_feat
    from toc3d_tpu.models.streampetr_head import head_forward as jax_head
    from toc3d_tpu_torch.core.coder import nms_free_decode
    from toc3d_tpu_torch.models.streampetr_head import (MemoryBank,
                                                        head_forward)
    jcfg, tcfg, rng, sd, params = _tiny_pair(7, quant=True)
    frames = make_frames(rng, jcfg, t_total=3)
    if static:
        fcfg = replace(jcfg, backbone=replace(jcfg.backbone, quant="none",
                                              fused_blocks=False))
        scales = jax_calib.calibrate_act_scales(
            params, fcfg, [{k: jnp.asarray(v) for k, v in f.items()}
                           for f in make_frames(rng, jcfg, t_total=2)])
        params = jax_calib.attach_act_scales(params, scales)
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jcfg)
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    td.precast_backbone_(model)
    assert all((getattr(b, "act_scales", None) is not None) == static
               for b in model.img_backbone.blocks)

    monkeypatch.setattr(jax_eva_vit, "jax", _TPUBackend())
    monkeypatch.setattr(jax_toc3d_vit, "jax", _TPUBackend())
    pre = _precast_backbone_params(params, jcfg)
    keys = ("intrinsics", "img2lidar", "timestamp", "ego_pose",
            "ego_pose_inv", "prev_exists")

    @jax.jit
    def jstep(p, mem, f):
        feats, _ = jax_feat(p, jcfg, f["img"], mem, f)
        data = dict({k: f[k] for k in keys}, pad_shape=jcfg.pad_shape)
        outs, new = jax_head(p["pts_bbox_head"], jcfg.head, feats, data, mem)
        return feats, outs, new

    jmem = jax_init_state(1, jcfg).memory
    for t, frame in enumerate(frames):
        jf = {k: jnp.asarray(v) for k, v in frame.items()}
        jfeat, jouts, jnew = jstep(pre, jmem, jf)
        tf = td.frame_to_device(frame, "cpu")
        tmem = MemoryBank(*(torch.from_numpy(np.array(m)) for m in jmem))
        with torch.no_grad():
            tfeat = td.extract_img_feat(model, tf["img"], tmem, tf, t > 0)
            data = dict({k: tf[k] for k in keys}, pad_shape=tcfg.pad_shape)
            touts, tnew = head_forward(model.pts_bbox_head, tcfg.head, tfeat,
                                       data, tmem)
        _close_int8(tfeat, jfeat)
        for k in ("all_cls_scores", "all_bbox_preds"):
            assert _mean_rel(_np(touts[k]), jouts[k]) <= 2e-3, (t, k)
        tdec = nms_free_decode(touts["all_cls_scores"],
                               touts["all_bbox_preds"], tcfg.head.num_classes,
                               tcfg.head.max_decode,
                               tcfg.head.post_center_range)
        jdec = jax_decode(jouts["all_cls_scores"], jouts["all_bbox_preds"],
                          jcfg.head.num_classes, jcfg.head.max_decode,
                          jcfg.head.post_center_range)
        np.testing.assert_allclose(np.sort(_np(tdec.scores[0])),
                                   np.sort(np.asarray(jdec.scores[0])),
                                   atol=1e-3, err_msg=f"frame {t} scores")
        rows_t = np.concatenate([_np(tnew.embedding[0]),
                                 _np(tnew.reference_point[0]),
                                 _np(tnew.velo[0])], -1)
        rows_j = np.concatenate([np.asarray(jnew.embedding[0]),
                                 np.asarray(jnew.reference_point[0]),
                                 np.asarray(jnew.velo[0])], -1)
        missed = len(rows_j) - _rows_matched(rows_t, rows_j, 1e-3)
        assert missed <= tcfg.head.topk_proposals, (t, missed)
        np.testing.assert_array_equal(_np(tnew.timestamp[0]).round(5),
                                      np.asarray(jnew.timestamp[0]).round(5))
        jmem = jnew


def test_int8_float32_on_card_is_rejected():
    """The int8 kernels take bf16 activations: precast refuses int8 with
    compute_dtype float32 for a model off the CPU (a meta-device model
    stands in for one on the card)."""
    cfg = get_config("tiny")
    cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"))
    with torch.device("meta"):
        model = td.ToC3DDetector(cfg)
    with pytest.raises(ValueError, match="bfloat16"):
        td.precast_backbone_(model)
