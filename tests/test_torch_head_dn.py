"""The port's PETRHeadDN (toc3d_tpu_torch/models/petr_head_dn.py) against
JAX's petr_head_dn_forward on the CPU in f32, with the same weights
(init_petr_head_dn through convert.head_state_from_jax): the tiny head of
tests/test_head_variants.py without DN and with DN, JAX's DN draw handed
to the port's prepare_for_dn. Tolerance: max |port - JAX| <= 1e-5 * max
|JAX| in every layer's scores and boxes; the DN mask equal."""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.core import dn as jdn
from toc3d_tpu.models import petr_head_dn as jhd
from toc3d_tpu.models.petr_transformer import (DecoderConfig as
                                               JDecoderConfig)

from toc3d_tpu_torch import convert
from toc3d_tpu_torch.core import dn as tdn
from toc3d_tpu_torch.models import petr_head_dn as thd
from toc3d_tpu_torch.models.petr_transformer import DecoderConfig

TOL = 1e-5
B, N = 2, 2


def _cfgs():
    kw = dict(embed_dims=32, in_channels=16, num_query=12, depth_num=32,
              dn_max_gt=4)
    dec = dict(embed_dims=32, num_heads=2, num_layers=2,
               feedforward_channels=64)
    return (jhd.petr_head_dn_config(**kw, decoder=JDecoderConfig(**dec)),
            thd.petr_head_dn_config(**kw, decoder=DecoderConfig(**dec)))


def _data(b, n):
    rng = np.random.RandomState(3)
    intr = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 1e3 + rng.rand(b, n) * 100
    i2l = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    i2l[..., :3, :3] += rng.randn(b, n, 3, 3).astype(np.float32) * 0.05
    i2l[..., :3, 3] = rng.randn(b, n, 3).astype(np.float32)
    return {"intrinsics": intr, "img2lidar": i2l, "pad_shape": (64, 128)}


@pytest.fixture(scope="module")
def heads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg, tcfg = _cfgs()
    params = jax.jit(lambda k: jhd.init_petr_head_dn(k, jcfg))(
        jax.random.PRNGKey(0))
    sd = convert.head_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    head = thd.build_petr_head_dn(tcfg, "cpu", state_dict=sd)
    feats = np.random.RandomState(0).randn(B, N, 4, 8, 16).astype(np.float32)
    yield jcfg, tcfg, params, head, feats
    torch.set_num_threads(threads)


def _close(got, want, msg):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (msg, err)


def test_head_dn_without_dn_matches_jax(heads):
    jcfg, tcfg, params, head, feats = heads
    data = _data(B, N)
    want = jax.jit(lambda p, f: jhd.petr_head_dn_forward(
        p, jcfg, f, {**{k: jnp.asarray(v) for k, v in data.items()
                        if k != "pad_shape"}, "pad_shape": (64, 128)}))(
        params, jnp.asarray(feats))
    tdata = {k: (torch.from_numpy(v) if k != "pad_shape" else v)
             for k, v in data.items()}
    with torch.no_grad():
        got = thd.petr_head_dn_forward(head, tcfg, torch.from_numpy(feats),
                                       tdata)
    assert set(got) == set(want) == {"all_cls_scores", "all_bbox_preds"}
    assert tuple(got["all_cls_scores"].shape) == (2, B, 12, 10)
    for k in want:
        _close(got[k], want[k], k)


def test_head_dn_with_dn_matches_jax(heads):
    """DN queries first under the DN mask (written-out self-attention):
    JAX's draw handed across; the port's mask with no propagated queries
    and no bank equals JAX's."""
    jcfg, tcfg, params, head, feats = heads
    rng = np.random.RandomState(1)
    boxes = rng.randn(B, 4, 9).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1
    labels = rng.randint(0, 10, (B, 4))
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    key = jax.random.PRNGKey(1)
    jd = jdn.prepare_for_dn(key, jcfg, jnp.asarray(boxes),
                            jnp.asarray(labels), jnp.asarray(valid))
    draw = np.asarray(jax.random.uniform(key, (B, jcfg.scalar, 4, 3),
                                         jnp.float32, -1.0, 1.0))
    td = tdn.prepare_for_dn(tcfg, torch.from_numpy(boxes),
                            torch.from_numpy(labels), torch.from_numpy(valid),
                            torch.from_numpy(np.array(draw)))
    assert td["pad_size"] == jd["pad_size"] == 40
    assert np.array_equal(td["attn_mask"].numpy(),
                          np.asarray(jd["attn_mask"]))
    assert td["attn_mask"].shape == (52, 52)
    jhead = {"padded_reference_points": jdn.dn_reference_points(
        jd, params["reference_points"], B),
        "attn_mask": jd["attn_mask"], "pad_size": jd["pad_size"]}
    data = _data(B, N)
    jdata = {**{k: jnp.asarray(v) for k, v in data.items()
                if k != "pad_shape"}, "pad_shape": (64, 128)}
    want = jax.jit(lambda p, f: jhd.petr_head_dn_forward(
        p, jcfg, f, jdata, dn=jhead))(params, jnp.asarray(feats))
    thead = {"padded_reference_points": tdn.dn_reference_points(
        td, head.reference_points.weight, B),
        "attn_mask": td["attn_mask"], "pad_size": td["pad_size"]}
    tdata = {k: (torch.from_numpy(v) if k != "pad_shape" else v)
             for k, v in data.items()}
    with torch.no_grad():
        got = thd.petr_head_dn_forward(head, tcfg, torch.from_numpy(feats),
                                       tdata, dn=thead)
    assert set(got) == set(want)
    assert tuple(got["dn_cls_scores"].shape) == (2, B, 40, 10)
    assert tuple(got["all_bbox_preds"].shape) == (2, B, 12, 10)
    for k in want:
        _close(got[k], want[k], k)


def test_head_dn_refuses_a_bank_config():
    _, tcfg = _cfgs()
    from dataclasses import replace
    with pytest.raises(ValueError):
        thd.PETRHeadDN(replace(tcfg, num_propagated=4))
