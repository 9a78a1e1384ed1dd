"""The selector's score_type 'score' in the port (toc3d_tpu_torch) against
the JAX package on the CPU in f32:

* selector_score on first frames (a mixed batch) and in steady state,
  with train_blend on and off, and its gradients against jax.grad;
  max |port - JAX| <= 1e-5 * max |JAX| (1e-4 for the gradients);
* the tiny detector with pruning_score_type 'score' streamed for 3 frames
  (prev_exists 0, 1, 1) from one reference-named state dict carrying
  aggregate.0.lin1 / lin2, loaded by the port with load_state_dict and by
  JAX through convert_detector_checkpoint: scores, boxes and the bank at
  1e-3 as tests/test_parity_detector.py, labels and validity equal;
* the route through apply_overrides, the trainer and eval CLIs
  (--cfg-options backbone.pruning_score_type=score) and the export.
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
from toc3d_tpu.models import token_select as jts
from toc3d_tpu.models.detector import infer_step as jax_infer_step
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint

from test_full_converter import build_reference_state_dict
from test_parity_detector import make_frames

from toc3d_tpu_torch import convert
from toc3d_tpu_torch.configs import apply_overrides, get_config
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.models import token_select as tts

TOL = 1e-5
SCORE = ["backbone.pruning_score_type=score"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol, msg):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (msg, err)


# ---------------------------------------------------------------------------
# selector_score
# ---------------------------------------------------------------------------

B, V, H, W, C, QD, NQ = 2, 2, 4, 6, 32, 16, 5


def _selector_inputs(seed):
    rng = np.random.RandomState(seed)
    ego = np.tile(np.eye(4, dtype=np.float32), (B, NQ, 1, 1))
    ego[..., :3, 3] = rng.randn(B, NQ, 3)
    inv = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    inv[:, :3, 3] = rng.randn(B, 3)
    ctx = {"temp_queries": rng.randn(B, NQ, QD),
           "temp_ref_points": rng.randn(B, NQ, 3) * 20,
           "temp_vel": rng.randn(B, NQ, 2),
           "temp_timestamp": -rng.rand(B, NQ, 1),
           "temp_ego_pose": ego, "ego_pose_inv": inv}
    ctx = {k: np.asarray(v, np.float32) for k, v in ctx.items()}
    tokens = rng.randn(B * V, H, W, C).astype(np.float32)
    mask = rng.rand(B * V, H, W, 1).astype(np.float32)
    cot = rng.randn(B * V, H * W, 2).astype(np.float32)
    return tokens, mask, ctx, cot


@pytest.fixture(scope="module")
def selectors():
    jcfg = jts.SelectorConfig(embed_dim=C, query_dim=QD, num_queries=NQ,
                              score_type="score")
    params = jax.tree_util.tree_map(
        np.asarray, jts.init_selector(jax.random.PRNGKey(0), jcfg))
    tcfg = tts.SelectorConfig(embed_dim=C, query_dim=QD, num_queries=NQ,
                              score_type="score")
    sel = td.build_module(lambda: tts.Selector(tcfg), "cpu",
                          convert.selector_state_from_jax(params))
    assert "aggregate.0.lin1.weight" in sel.state_dict()
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, params), sel


@pytest.mark.parametrize("prev", [(0.0, 1.0), (1.0, 1.0)],
                         ids=["first", "steady"])
@pytest.mark.parametrize("train_blend", [False, True])
def test_selector_score_and_grads_match_jax(selectors, prev, train_blend):
    jcfg, tcfg, params, sel = selectors
    tokens, mask, ctx, cot = _selector_inputs(1)
    pe = np.asarray(prev, np.float32)
    jctx = {k: jnp.asarray(v) for k, v in ctx.items()}

    def jloss(p, x):
        scores, pred, attn = jts.selector_score(
            p, jcfg, x, jnp.asarray(mask), jctx, jnp.asarray(pe),
            train_blend=train_blend)
        return jnp.sum(pred * cot), (scores, pred, attn)

    (_, (jscores, jpred, jattn)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(tokens))
    assert jattn is None

    x = T(tokens).requires_grad_(True)
    sel.zero_grad()
    scores, pred, attn = tts.selector_score(
        sel, tcfg, x, T(mask), {k: T(v) for k, v in ctx.items()}, T(pe),
        train_blend=train_blend)
    assert attn is None
    (pred * T(cot)).sum().backward()
    _close(scores, jscores, TOL, "scores")
    _close(pred, jpred, TOL, "pred")
    _close(x.grad, gx, 1e-4, "d tokens")
    for name, g in (("aggregate.0.lin1.weight", gp["aggregate"]["lin1"]["w"]),
                    ("aggregate.0.lin2.weight", gp["aggregate"]["lin2"]["w"]),
                    ("input_proj.0.weight", gp["input_proj"]["w"]),
                    ("out_conv.4.weight", gp["score_mlp"]["out_fc2"]["w"])):
        got = dict(sel.named_parameters())[name].grad
        if prev == (1.0, 1.0) and name.startswith("out_conv"):
            assert got is None or not got.abs().any()
            continue
        _close(got, np.asarray(g).T, 1e-4, f"d {name}")


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def score_state_dict(jcfg, rng):
    """build_reference_state_dict with each selector's aggregate.0 Linear
    replaced by the MLPBlock of score_type 'score'."""
    sd = build_reference_state_dict(jcfg, rng)
    qd = jcfg.backbone.query_dim
    for i in range(len(jcfg.backbone.pruning_loc)):
        pre = f"img_backbone.score_predictor.{i}.aggregate.0."
        del sd[pre + "weight"], sd[pre + "bias"]
        for name, (fi, fo) in (("lin1", (2 * qd, qd)), ("lin2", (qd, 2))):
            sd[pre + name + ".weight"] = (rng.randn(fo, fi) / np.sqrt(fi)
                                          ).astype(np.float32)
            sd[pre + name + ".bias"] = (rng.randn(fo) * 0.1).astype(
                np.float32)
    return sd


def test_tiny_score_detector_streams_like_jax():
    jcfg = jax_get_config("tiny")
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone,
                                          pruning_score_type="score"))
    tcfg = apply_overrides(get_config("tiny"), SCORE)
    assert tcfg.backbone.pruning_score_type == "score"
    rng = np.random.RandomState(7)
    sd = score_state_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    # the JAX tree maps back onto the same reference names
    back = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jcfg)
    agg = [k for k in sd if ".aggregate." in k]
    assert len(agg) == 4 * len(jcfg.backbone.pruning_loc)
    for k in agg:
        assert np.array_equal(back[k].numpy(), sd[k]), k

    frames = make_frames(rng, jcfg, t_total=3)
    step = jax.jit(lambda p, s, f: jax_infer_step(p, jcfg, s, f))
    jstate = jax_init_state(1, jcfg)
    tstate = td.init_state(1, tcfg, device="cpu")
    for t, frame in enumerate(frames):
        jstate, jdet = step(params, jstate,
                            {k: jnp.asarray(v) for k, v in frame.items()})
        tstate, tdet = td.infer_step(model, tstate,
                                     td.frame_to_device(frame, "cpu"))
        np.testing.assert_allclose(tdet.scores[0].numpy(),
                                   np.asarray(jdet.scores[0]), atol=1e-3,
                                   err_msg=f"frame {t} scores")
        np.testing.assert_allclose(tdet.bboxes[0].numpy(),
                                   np.asarray(jdet.bboxes[0]), atol=1e-3,
                                   rtol=1e-3, err_msg=f"frame {t} boxes")
        assert (tdet.labels[0].numpy() == np.asarray(jdet.labels[0])).all()
        assert (tdet.valid[0].numpy() == np.asarray(jdet.valid[0])).all()
        for name in ("embedding", "reference_point", "egopose"):
            np.testing.assert_allclose(
                getattr(tstate.memory, name)[0].numpy(),
                np.asarray(getattr(jstate.memory, name)[0]), atol=1e-3,
                err_msg=f"frame {t} memory {name}")


def test_attention_state_dict_refused_by_a_score_model():
    """An 'attention' checkpoint (aggregate.0 a Linear) does not load into
    a 'score' detector: the names differ, strict loading raises."""
    sd = build_reference_state_dict(jax_get_config("tiny"),
                                    np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="aggregate"):
        td.build_detector(apply_overrides(get_config("tiny"), SCORE),
                          device="cpu", state_dict=sd)


def test_score_route_through_train_eval_and_export(tmp_path):
    """--cfg-options backbone.pruning_score_type=score through the trainer
    CLI (one iteration, its eval through the eval CLI's path), and the
    'score' detector exported and loaded: its call equal to the eager
    make_infer_fn bit for bit over 2 frames."""
    from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
    from toc3d_tpu_torch.runtime.export import export_detector, load_detector
    from toc3d_tpu_torch.tools import train as cli
    synth = make_learnable_dataset(str(tmp_path / "data"), n_scenes=1,
                                   frames_per_scene=2, src_h=90, src_w=160)
    out = cli.main(["--device", "cpu", "--config", "tiny", "--ann", synth,
                    "--batch-size", "1", "--seq-split-num", "1",
                    "--log-interval", "1", "--checkpoint-interval", "9",
                    "--src-h", "90", "--src-w", "160", "--iters", "1",
                    "--work-dir", str(tmp_path / "train"), "--val-ann",
                    synth, "--eval-limit", "2", "--cfg-options", *SCORE])
    assert np.isfinite(out["records"][0]["total_loss"])
    assert 0.0 <= out["evals"][1]["mAP"] <= 1.0
    sel = out["state"].model.img_backbone.score_predictor[0]
    assert isinstance(sel.aggregate[0], tts.MLPBlock)

    model = td.build_detector(apply_overrides(get_config("tiny"), SCORE),
                              device="cpu", seed=1)
    export_detector(model, str(tmp_path / "art"), num_views=2)
    loaded = load_detector(str(tmp_path / "art"), device="cpu")
    infer = td.make_infer_fn(model)
    frames = make_frames(np.random.RandomState(2), model.cfg, t_total=2)
    a = b = td.init_state(1, model.cfg, device="cpu")
    for frame in frames:
        a, da = loaded(a, frame)
        b, db = infer(b, frame)
        for x, y in zip(tuple(da) + tuple(a.memory),
                        tuple(db) + tuple(b.memory)):
            assert torch.equal(x, y)
