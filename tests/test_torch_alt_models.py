"""The port's modules outside the shipped configs (toc3d_tpu_torch) against
the JAX package on the CPU in f32: models/common.py (MLPBlock, FastMlp,
LayerNorm2d), eva_vit.ResBottleneck, ops/rel_pos.py, the box and bilinear
resize helpers, VoVNet, ViTSimpleFPN and the PETR encoder. JAX's weights
come across through the convert.*_state_from_jax entry points. Tolerance:
max |port - JAX| <= 1e-5 * max |JAX| (TOL) unless a test says otherwise;
the numpy helpers are compared exactly. Last, the host-pipeline twin
(toc3d_tpu_torch/tools/host_pipeline_bench.py) on the CPU."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from toc3d_tpu.core import boxes as jboxes
from toc3d_tpu.models import common as jcommon
from toc3d_tpu.models.eva_vit import init_res_bottleneck, res_bottleneck
from toc3d_tpu.models.petr_transformer import (DecoderConfig as JDecoderConfig,
                                               encoder_forward as jencoder,
                                               init_encoder_layer)
from toc3d_tpu.models.vit_simple_fpn import (
    ViTSimpleFPNConfig as JFPNConfig, init_vit_simple_fpn,
    vit_simple_fpn_forward as jfpn_forward)
from toc3d_tpu.models.vovnet import (VoVNetConfig as JVoVNetConfig,
                                     _maxpool_ceil, init_vovnet,
                                     vovnet_forward as jvovnet_forward)
from toc3d_tpu.layers import init_layer_norm
from toc3d_tpu.ops import rel_pos as jrel
from toc3d_tpu.ops import resize as jresize

from toc3d_tpu_torch import convert
from toc3d_tpu_torch.core import boxes as tboxes
from toc3d_tpu_torch.models import common as tcommon
from toc3d_tpu_torch.models.detector import build_module
from toc3d_tpu_torch.models.eva_vit import (ResBottleneck,
                                            init_res_bottleneck_,
                                            res_bottleneck as tres)
from toc3d_tpu_torch.models.petr_transformer import (DecoderConfig, Encoder,
                                                     encoder_forward)
from toc3d_tpu_torch.models.vit_simple_fpn import (ViTSimpleFPN,
                                                   ViTSimpleFPNConfig,
                                                   vit_simple_fpn_forward)
from toc3d_tpu_torch.models.vovnet import (VoVNet, VoVNetConfig,
                                           maxpool_ceil, vovnet_forward)
from toc3d_tpu_torch.ops import rel_pos as trel
from toc3d_tpu_torch.ops import resize as tresize

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (msg, err)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _lin_sd(pre, p):
    return {f"{pre}.weight": T(np.asarray(p["w"]).T), f"{pre}.bias": T(p["b"])}


# ---------------------------------------------------------------------------
# common blocks
# ---------------------------------------------------------------------------

def test_common_blocks_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    pm = to_np(jcommon.init_mlp_block(k[0], 16, 24, 3))
    m = tcommon.MLPBlock(16, 24, 3)
    m.load_state_dict({**_lin_sd("lin1", pm["lin1"]),
                       **_lin_sd("lin2", pm["lin2"])})
    close(m(T(x)), jcommon.mlp_block(pm, jnp.asarray(x)), msg="MLPBlock")

    pf = to_np(jcommon.init_fast_mlp(k[1], 16, mlp_ratio=2))
    f = tcommon.FastMlp(16, mlp_ratio=2)
    f.load_state_dict({**_lin_sd("fc1", pf["fc1"]),
                       **_lin_sd("fc2", pf["fc2"])})
    close(f(T(x)), jcommon.fast_mlp(pf, jnp.asarray(x)), msg="FastMlp")

    xm = rng.randn(2, 3, 4, 16).astype(np.float32) * 3 + 1
    pn = {"scale": rng.rand(16).astype(np.float32) + 0.5,
          "bias": rng.randn(16).astype(np.float32)}
    n = tcommon.LayerNorm2d(16)
    n.load_state_dict({"weight": T(pn["scale"]), "bias": T(pn["bias"])})
    close(n(T(xm)), jcommon.layer_norm_2d(
        jax.tree_util.tree_map(jnp.asarray, pn), jnp.asarray(xm)),
        msg="LayerNorm2d")


def test_res_bottleneck_matches_jax():
    """A non-zero norm3 (the init's zero would hide the block), and the
    port's own init is the identity as JAX's is."""
    rng = np.random.RandomState(1)
    p = to_np(init_res_bottleneck(jax.random.PRNGKey(2), 16))
    p["norm3"] = {"scale": rng.rand(16).astype(np.float32) + 0.5,
                  "bias": rng.randn(16).astype(np.float32) * 0.1}
    for i in (1, 2):
        p[f"norm{i}"] = {"scale": rng.rand(8).astype(np.float32) + 0.5,
                         "bias": rng.randn(8).astype(np.float32) * 0.1}
    x = rng.randn(2, 6, 5, 16).astype(np.float32)
    m = build_module(lambda: ResBottleneck(16), "cpu",
                     convert.res_bottleneck_state_from_jax(p))
    want = jax.jit(res_bottleneck)(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x))
    close(tres(m, T(x)), want, msg="ResBottleneck")
    assert float(np.abs(np.asarray(want) - x).max()) > 0.1
    fresh = build_module(lambda: ResBottleneck(16), "cpu", seed=3,
                         init=init_res_bottleneck_)
    assert torch.equal(tres(fresh, T(x)), T(x))


# ---------------------------------------------------------------------------
# relative positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,k,length", [(8, 8, 15), (8, 8, 9), (4, 8, 15),
                                        (6, 3, 7), (5, 5, 21)])
def test_get_rel_pos_matches_jax(q, k, length):
    """Tables of the wanted length 2 * max(q, k) - 1 are gathered; others
    (9, 7, 21 here) go through the log-spaced cubic resize."""
    table = np.random.RandomState(q * 31 + length).randn(
        length, 6).astype(np.float32)
    close(trel.get_rel_pos(q, k, T(table)), jrel.get_rel_pos(q, k, table),
          msg=f"q {q} k {k} L {length}")


def test_add_decomposed_rel_pos_matches_jax():
    rng = np.random.RandomState(4)
    b, qh, qw, kh, kw, c = 2, 4, 5, 4, 5, 8
    attn = rng.randn(b, qh * qw, kh * kw).astype(np.float32)
    q = rng.randn(b, qh * qw, c).astype(np.float32)
    rh = rng.randn(2 * qh - 1, c).astype(np.float32)
    rw = rng.randn(11, c).astype(np.float32)       # forces the resize
    got = trel.add_decomposed_rel_pos(T(attn), T(q), T(rh), T(rw),
                                      (qh, qw), (kh, kw))
    want = jrel.add_decomposed_rel_pos(jnp.asarray(attn), jnp.asarray(q),
                                       rh, rw, (qh, qw), (kh, kw))
    close(got, want)


# ---------------------------------------------------------------------------
# box and resize helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [7, 9])
def test_box_helpers_match_jax(dim):
    boxes = np.random.RandomState(dim).randn(12, dim).astype(np.float32)
    for name in ("gravity_center", "boxes_with_gravity_center"):
        assert np.array_equal(getattr(tboxes, name)(boxes),
                              getattr(jboxes, name)(boxes)), name
    for direction in ("horizontal", "vertical", "neither"):
        assert np.array_equal(tboxes.flip_boxes(boxes, direction),
                              jboxes.flip_boxes(boxes, direction)), direction


@pytest.mark.parametrize("n_in,n_out,align", [(7, 13, False), (13, 7, False),
                                              (7, 13, True), (5, 5, False),
                                              (16, 4, True)])
def test_bilinear_matrix_matches_jax(n_in, n_out, align):
    assert np.array_equal(
        tresize.bilinear_weight_matrix(n_in, n_out, align),
        jresize.bilinear_weight_matrix(n_in, n_out, align))


def test_resize_bilinear_matches_jax_and_torch():
    x = np.random.RandomState(5).randn(2, 3, 9, 14).astype(np.float32)
    got = tresize.resize_bilinear_2d(T(x), 20, 6)
    close(got, jresize.resize_bilinear_2d(jnp.asarray(x), 20, 6))
    close(got, F.interpolate(T(x), size=(20, 6), mode="bilinear",
                             align_corners=False))


# ---------------------------------------------------------------------------
# VoVNet
# ---------------------------------------------------------------------------

def _perturb_bn(tree, rng):
    """Non-trivial frozen BN statistics on every norm of a VoVNet tree."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape[0]
            return {"scale": rng.rand(c).astype(np.float32) + 0.5,
                    "bias": rng.randn(c).astype(np.float32) * 0.2,
                    "mean": rng.randn(c).astype(np.float32) * 0.2,
                    "var": rng.rand(c).astype(np.float32) + 0.5}
        return {k: _perturb_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_bn(v, rng) for v in tree]
    return tree


def test_vovnet39_matches_jax():
    """V-39-eSE at (1, 64, 96, 3), every stage's output, against JAX with
    the same weights and non-trivial BN statistics."""
    outs = ("stem", "stage2", "stage3", "stage4", "stage5")
    jcfg = JVoVNetConfig("V-39-eSE", out_features=outs)
    params = _perturb_bn(to_np(jax.jit(lambda k: init_vovnet(k, jcfg))(
        jax.random.PRNGKey(0))), np.random.RandomState(6))
    x = np.random.RandomState(7).randn(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jvovnet_forward(p, x, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    model = build_module(lambda: VoVNet(VoVNetConfig("V-39-eSE", 3, outs)),
                         "cpu", convert.vovnet_state_from_jax(params))
    with torch.no_grad():
        got = vovnet_forward(model, T(x))
    assert len(got) == len(want) == 5
    for name, g, w in zip(outs, got, want):
        close(g, w, msg=name)


def test_vovnet99_shapes_and_names():
    """V-99-eSE in the port alone: stage4 / stage5 at stride 16 / 32, and
    the reference's module names (one eSE gate a stage, on its last
    block)."""
    model = build_module(lambda: VoVNet(VoVNetConfig("V-99-eSE")), "cpu",
                         seed=0)
    with torch.no_grad():
        s4, s5 = vovnet_forward(model, torch.ones(1, 64, 96, 3))
    assert tuple(s4.shape) == (1, 4, 6, 768)
    assert tuple(s5.shape) == (1, 2, 3, 1024)
    assert bool(torch.isfinite(s5).all())
    keys = model.state_dict().keys()
    for k in ("stem.stem_1/conv.weight", "stem.stem_3/norm.running_var",
              "stage2.OSA2_1.layers.0.OSA2_1_0/conv.weight",
              "stage4.OSA4_9.concat.OSA4_9_concat/conv.weight",
              "stage5.OSA5_3.ese.fc.bias"):
        assert k in keys, k
    assert sorted(k for k in keys if k.endswith("ese.fc.weight")) == [
        "stage2.OSA2_1.ese.fc.weight", "stage3.OSA3_3.ese.fc.weight",
        "stage4.OSA4_9.ese.fc.weight", "stage5.OSA5_3.ese.fc.weight"]


@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (13, 5), (3, 3)])
def test_maxpool_ceil_matches_jax(h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 4).astype(np.float32)
    got = maxpool_ceil(T(x))
    want = np.asarray(_maxpool_ceil(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ViTSimpleFPN and the encoder
# ---------------------------------------------------------------------------

def test_vit_simple_fpn_matches_jax_at_every_scale():
    scales = (4.0, 2.0, 1.0, 0.5, 0.25)
    jcfg = JFPNConfig(in_channels=16, out_channels=8, scale_factors=scales,
                      num_outs=6)
    params = to_np(jax.jit(lambda k: init_vit_simple_fpn(k, jcfg))(
        jax.random.PRNGKey(1)))
    rng = np.random.RandomState(8)
    for st in params["stages"]:
        if "gn1" in st:
            c = st["gn1"]["scale"].shape[0]
            st["gn1"] = {"scale": rng.rand(c).astype(np.float32) + 0.5,
                         "bias": rng.randn(c).astype(np.float32) * 0.2}
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    want = jax.jit(lambda p, x: jfpn_forward(p, x, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    cfg = ViTSimpleFPNConfig(in_channels=16, out_channels=8,
                             scale_factors=scales, num_outs=6)
    model = build_module(lambda: ViTSimpleFPN(cfg), "cpu",
                         convert.vit_simple_fpn_state_from_jax(params))
    with torch.no_grad():
        got = vit_simple_fpn_forward(model, T(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 32, 48, 8), (2, 16, 24, 8), (2, 8, 12, 8), (2, 4, 6, 8),
        (2, 2, 3, 8), (2, 1, 2, 8)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, msg=f"level {i}")


@pytest.mark.parametrize("post_norm", [False, True])
def test_encoder_matches_jax(post_norm):
    jcfg = JDecoderConfig(embed_dims=32, num_heads=2, num_layers=2,
                          feedforward_channels=64)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    p = {"layers": [init_encoder_layer(k, jcfg) for k in keys[:2]]}
    if post_norm:
        p["post_norm"] = init_layer_norm(32)
    p = to_np(p)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 10, 32).astype(np.float32)
    pos = rng.randn(2, 10, 32).astype(np.float32)
    want = jax.jit(lambda p, x, pos: jencoder(p, jcfg, x, pos))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(pos))
    cfg = DecoderConfig(embed_dims=32, num_heads=2, num_layers=2,
                        feedforward_channels=64)
    enc = build_module(lambda: Encoder(cfg, 2, post_norm), "cpu",
                       convert.encoder_state_from_jax(p))
    with torch.no_grad():
        close(encoder_forward(enc, cfg, T(x), T(pos)), want)


# ---------------------------------------------------------------------------
# the host-pipeline twin
# ---------------------------------------------------------------------------

def _jax_tool_keys():
    """The keys of the JSON record of tools/host_pipeline_bench.py, read
    from its source (the dict assigned to ``out``)."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "tools"
           / "host_pipeline_bench.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record in the JAX tool")


def test_host_pipeline_twin_on_cpu(capsys):
    """python -m toc3d_tpu_torch.tools.host_pipeline_bench --device cpu
    --config tiny: one distinct set of six 1600x900 JPEGs, 3 timed frames
    after 1 warm-up; the JSON line carries the JAX tool's keys and the
    device, and its temporary directory is gone."""
    import json
    import tempfile
    from toc3d_tpu_torch.tools import host_pipeline_bench as hp
    before = set(os.listdir(tempfile.gettempdir()))
    out = hp.main(["--device", "cpu", "--config", "tiny", "--frames", "3",
                   "--warmup", "1", "--distinct", "1", "--host-probe", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    keys = _jax_tool_keys()
    assert len(keys) == 14 and keys <= set(out)
    assert set(out) - keys == {"device"}
    assert out["device"] == "cpu" and out["unit"] == "frames/s"
    for k in ("host_exact_ms", "host_fast_ms", "host_fast_u8_ms",
              "infer_ms", "infer_u8_ms", "e2e_exact_ms", "e2e_fast_ms"):
        assert out[k] > 0, k
    assert out["overlap_eff_fast"] == pytest.approx(
        out["infer_u8_ms"] / out["e2e_fast_ms"], rel=0.05)
    assert not {d for d in set(os.listdir(tempfile.gettempdir())) - before
                if d.startswith("hostpipe_")}
