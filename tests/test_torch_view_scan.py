"""The 1600x800 training regime of the port on the CPU, in f32 at the
``tiny`` preset with stochastic depth on (drop_path_rate 0.1, so blocks 1
and 3 run the model path with their keep masks), b 2 lanes of n 3 views:
the view scan (models/detector.extract_img_feat ``view_scan``) and the
chunked backbone attention (ops/attention.py ``attn_chunk``), the twins of
JAX's (tests/test_view_scan.py is their oracle there).

* The port against itself: the scanned backbone (cs 1 and 3) computes what
  the unscanned one computes, features, token masks and parameter
  gradients, within 1e-5: each chunk reads its own rows of the noise, so
  the two are the same function. The chunked attention (chunks of 5 and 3
  windows of 12 and 4, so the last chunk is shorter) likewise, with and
  without the view scan. A chunk that does not divide N raises.
* The port against JAX: make_train_step with the view scan (a view a
  chunk) and the chunked attention (chunks of 3 of a chunk's 4 windows),
  two steps (the first frame of a scene, then the next on the bank the
  first left) against JAX's make_train_step with the same two options,
  with every draw handed across (tests/test_torch_train_step.jax_noise:
  JAX's per-chunk draws placed in the port's b-major rows). One JAX
  program holds both options, as one compile keeps the file's time down;
  each option alone is held to the plain backbone above. Tolerances of
  tests/test_torch_train_step.py: the losses and grad_norm 1e-4, every
  gradient 1e-4, the bank 1e-3.
* The policy: auto_view_scan equals JAX's on every preset.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import PRESETS as JAX_PRESETS
from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.core import assigner as jax_assigner
from toc3d_tpu.models.detector import init_detector
from toc3d_tpu.runtime import train as jt

from toc3d_tpu_torch.configs import PRESETS, get_config
from toc3d_tpu_torch.convert import params_from_jax
from toc3d_tpu_torch.models.detector import build_detector, extract_img_feat
from toc3d_tpu_torch.models.streampetr_head import init_memory
from toc3d_tpu_torch.runtime import train as tt

from test_torch_train_step import (BANK, _frame_grads, _metrics_match,
                                   _with_droppath, jax_first_moment,
                                   jax_noise, make_batch)

B, N = 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny steps in one thread: under the suite's parallel
    workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    """The tiny port with stochastic depth, a batch of B x N views on the
    next frame of a scene (prev_exists 1) with a bank whose lanes differ,
    so the selectors read each lane's motion queries, and one draw of the
    step's noise."""
    cfg = _with_droppath(get_config("tiny"))
    model = build_detector(cfg, device="cpu", seed=0)
    bt = make_batch(np.random.RandomState(0), B, N, *cfg.pad_shape)
    bt["prev_exists"][:] = 1.0
    batch, steady = tt.batch_to_device(bt, "cpu")
    g = torch.Generator().manual_seed(3)
    mem = init_memory(B, cfg.head, "cpu")
    mem = type(mem)(*(torch.randn(t.shape, generator=g) if t.is_floating_point()
                      else t for t in mem))
    noise = tt.draw_train_noise(cfg, B, N, g, "cpu")
    return dict(model=model, batch=batch, steady=steady, memory=mem,
                noise=noise)


def _backbone(port, view_scan=False, attn_chunk=None, grads=True):
    """The training forward of extract_img_feat; the features, the token
    masks and, with grads, the backbone's parameter gradients of a loss
    that reads both."""
    model = port["model"]
    params = [p for n, p in model.named_parameters()
              if n.startswith("img_backbone.")]
    with torch.set_grad_enabled(grads):
        f, aux = extract_img_feat(
            model, port["batch"]["img"], port["memory"], port["batch"],
            steady=port["steady"], mask_noise=port["noise"].gumbel,
            train=True, dp_keep=port["noise"].drop_path, remat=True,
            view_scan=view_scan, attn_chunk=attn_chunk)
        masks = aux["token_masks"]
        if not grads:
            return f, masks, None
        loss = (f ** 2).sum() + sum((m * m.detach()).sum() for m in masks)
        g = torch.autograd.grad(loss, params, allow_unused=True)
    return f.detach(), [m.detach() for m in masks], g


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, (what, i)
            continue
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale,
                                   msg=f"{what} {i}")


@pytest.fixture(scope="module")
def unscanned(port):
    return _backbone(port)


@pytest.mark.parametrize("view_scan", [True, 1, 3])
def test_view_scan_matches_unscanned(port, unscanned, view_scan):
    """Features, token masks and the backbone's parameter gradients of the
    scanned backbone equal the unscanned one's (detector.py:104-200, its
    b-major rows: the selectors' motion queries broadcast over bn // b
    contiguous rows)."""
    f0, m0, g0 = unscanned
    f1, m1, g1 = _backbone(port, view_scan=view_scan)
    assert len(m1) == len(m0) == 1 and m1[0].shape == m0[0].shape
    _close([f1], [f0], "features")
    _close(m1, m0, "token masks")
    assert sum(g is not None for g in g0) > 10
    _close(g1, g0, "gradients")


@pytest.mark.parametrize("view_scan,attn_chunk", [(False, 5), (1, 3)])
def test_attn_chunk_matches_unchunked(port, unscanned, view_scan,
                                      attn_chunk):
    """The chunked attention (attention.py:56-79): 12 windows a block in
    chunks of 5, 5 and 2, or 4 a view chunk in chunks of 3 and 1. It runs
    in the forward of the droppath blocks and in every Function's backward;
    forward and parameter gradients equal the unchunked ones, and so does
    a forward without autograd."""
    f0, m0, g0 = unscanned
    f1, m1, g1 = _backbone(port, view_scan, attn_chunk)
    _close([f1], [f0], "features")
    _close(m1, m0, "token masks")
    _close(g1, g0, "gradients")
    f2, m2, _ = _backbone(port, view_scan, attn_chunk, grads=False)
    _close([f2], [f0], "features without autograd")


def test_view_scan_chunk_must_divide(port):
    """A chunk that does not divide the 3 views raises, as in JAX
    (detector.py:161-164); so does the collected forward with a view
    scan (:155-159)."""
    with pytest.raises(ValueError, match="must divide"):
        _backbone(port, view_scan=2, grads=False)
    with pytest.raises(NotImplementedError, match="view_scan"):
        extract_img_feat(port["model"], port["batch"]["img"], port["memory"],
                         port["batch"], collect_block_outs=True,
                         view_scan=True)


def test_auto_view_scan_matches_jax():
    """JAX's policy on every preset and the ratio-sweep names: on at
    1600x800, off at 800x320 and at the tiny preset's 64x128."""
    assert set(PRESETS) == set(JAX_PRESETS)
    names = sorted(PRESETS) + ["ToC3D_ratio543", "ToC3D_ratio543_1600"]
    for name in names:
        want = jt.auto_view_scan(jax_get_config(name))
        assert tt.auto_view_scan(get_config(name)) == want, name
        assert want == (get_config(name).pad_shape[0] >= 800), name
    assert tt.auto_view_scan(get_config("ToC3D_faster_1600"))
    assert not tt.auto_view_scan(get_config("ToC3D_faster"))


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

OPTS = dict(view_scan=True, attn_chunk=3)


@pytest.fixture(scope="module")
def both():
    """Two steps on each side from the same weights with OPTS (the first
    frame of a scene, then the next on the bank the first left); snapshots
    after each: metrics, first moments, bank."""
    opts = OPTS
    jcfg = _with_droppath(jax_get_config("tiny"))
    params = jax.jit(lambda k: init_detector(k, jcfg))(jax.random.PRNGKey(0))
    tcfg = _with_droppath(get_config("tiny"))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    batches = [make_batch(np.random.RandomState(s), B, N, *jcfg.pad_shape)
               for s in (0, 1)]
    batches[1]["prev_exists"][:] = 1.0
    batches[1]["timestamp"][:] = 1.0
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    tx = jt.make_optimizer(params, total_iters=100)
    state = jt.init_train_state(params, tx, B, jcfg)
    jstep = jax.jit(jt.make_train_step(jcfg, tx, **opts))
    jax_out = []
    jax_assigner.set_default_impl("callback")
    try:
        for bt, key in zip(batches, keys):
            state, metrics = jstep(
                state, jax.tree_util.tree_map(jnp.asarray, bt), key)
            jax_out.append(dict(
                memory=state.memory,
                metrics={k: float(v) for k, v in metrics.items()},
                mu=jax_first_moment(state.opt_state, tcfg)))
    finally:
        jax_assigner.set_default_impl(None)
    model = build_detector(tcfg, device="cpu",
                           state_dict=params_from_jax(params_np, tcfg))
    ttx = tt.make_optimizer(model, total_iters=100)
    tstate = tt.init_train_state(model, ttx, B)
    tstep = tt.make_train_step(ttx, **opts)
    port_out = []
    for bt, key in zip(batches, keys):
        tb, steady = tt.batch_to_device(bt, "cpu")
        noise = jax_noise(jcfg, key, B, N, opts["view_scan"])
        tstate, tmetrics = tstep(tstate, tb, noise, steady=steady)
        port_out.append(dict(
            memory=tstate.memory,
            metrics={k: float(v) for k, v in tmetrics.items()},
            mu=dict(zip(ttx.names, (m.clone() for m in
                                    tstate.opt_state["mu"])))))
    return dict(jax=jax_out, port=port_out)


@pytest.mark.parametrize("frame", [0, 1])
def test_step_losses_and_grad_norm_match_jax(both, frame):
    _metrics_match(both["jax"][frame]["metrics"],
                   both["port"][frame]["metrics"])


@pytest.mark.parametrize("frame", [0, 1])
def test_step_gradients_match_jax(both, frame):
    """Every parameter's gradient, read from AdamW's first moments as in
    tests/test_torch_train_step.py, within 1e-4 relative and 1e-4 of the
    tensor's largest (at the second step, its largest over both)."""
    want = _frame_grads(both["jax"], frame)
    got = _frame_grads(both["port"], frame)
    prev = _frame_grads(both["jax"], 0) if frame else want
    assert set(got) == set(want)
    for k in sorted(want):
        scale = max(np.abs(want[k]).max(), np.abs(prev[k]).max(), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    live = {k for k, v in want.items() if np.abs(v).max() > 0}
    assert len(live) > 0.8 * len(want), len(live)
    if frame == 1:      # the selectors' motion queries, lane by lane
        assert "img_backbone.score_predictor.0.query_embedding.0.weight" \
            in live


@pytest.mark.parametrize("frame", [0, 1])
def test_step_bank_matches_jax(both, frame):
    for name in BANK:
        np.testing.assert_allclose(
            getattr(both["port"][frame]["memory"], name).numpy(),
            np.asarray(getattr(both["jax"][frame]["memory"], name)),
            atol=1e-3, err_msg=name)
