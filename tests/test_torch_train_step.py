"""One training step of the port against the JAX package's, on the CPU in
f32 at the ``tiny`` preset (runtime/train.py against
toc3d_tpu/runtime/train.py), with stochastic depth on (drop_path_rate 0.1
on both sides, so the full block 1 runs the model path with its masks) and
the decoder's dropout 0.1 as the preset has it. Every draw of JAX's step
is handed across: the grid mask, the selector's gumbel noise, the DN
uniform, the stochastic-depth and the dropout masks, each rebuilt from
JAX's own key tree (train.py:194, toc3d_vit.py:266-268 and :354,
eva_vit.py:285-286, petr_transformer.py:75, :142-166, dn.py:46,
grid_mask.py:22-29).

A second step follows on the next frame (prev_exists 1) with the bank the
first left. Tolerances: every loss term, the total and grad_norm within
1e-4 relative, at both steps; every parameter's gradient, read from
AdamW's first moments (mu_t = b1 mu_(t-1) + (1 - b1) x the clipped
gradient, on both sides), within 1e-4 relative and 1e-4 of its tensor's
largest, at both steps; the parameters after the first update within
1e-5 (see the test for the elements whose gradient is rounding); the new
bank within 1e-3 (tests/test_parity_detector.py's limit). Also: the optimizer
(the lr schedule against optax, the labels, layer decay, the skip of a
non-finite step, AdamW against optax's chain over several steps), and
save / resume. The multi-frame losses: tests/test_torch_train_multiframe.py.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.core import assigner as jax_assigner
from toc3d_tpu.models.detector import init_detector
from toc3d_tpu.models.eva_vit import (drop_path_rates,
                                      get_vit_lr_decay_rate as jax_decay)
from toc3d_tpu.runtime import train as jt

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.convert import params_from_jax
from toc3d_tpu_torch.models.detector import build_detector
from toc3d_tpu_torch.models.grid_mask import GridDraw
from toc3d_tpu_torch.runtime import train as tt
from toc3d_tpu_torch.runtime.checkpoint import (load_train_state,
                                                save_train_state)

BANK = ("embedding", "reference_point", "timestamp", "egopose", "velo")


def make_batch(rng, b, n, h, w, g3=4, g2=4):
    """A synthetic batch (tests/test_train.py:13-39), numpy."""
    eye = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    intr = eye.copy()
    intr[..., 0, 0] = intr[..., 1, 1] = 1.2e3
    boxes = rng.randn(b, g3, 9).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1.0
    b2d = np.sort(np.abs(rng.rand(b, n, g2, 2, 2)).astype(np.float32) * 30,
                  axis=-2).reshape(b, n, g2, 4)
    return {
        "img": rng.randn(b, n, h, w, 3).astype(np.float32),
        "intrinsics": intr, "img2lidar": eye,
        "timestamp": np.full((b,), 0.5, np.float32),
        "ego_pose": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "ego_pose_inv": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "prev_exists": np.zeros((b,), np.float32),
        "gt_bboxes_3d": boxes,
        "gt_labels_3d": rng.randint(0, 10, (b, g3)),
        "gt_valid_3d": np.ones((b, g3), bool),
        "gt_bboxes_2d": b2d,
        "gt_labels_2d": rng.randint(0, 10, (b, n, g2)),
        "gt_centers_2d": rng.rand(b, n, g2, 2).astype(np.float32) * 30,
        "gt_valid_2d": np.ones((b, n, g2), bool),
    }


def _with_droppath(cfg, rate=0.1):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, drop_path_rate=rate))


def jax_noise(jcfg, key, b, n):
    """JAX's draws of compute_losses(rng=key) as the port's TrainNoise."""
    T = lambda a: torch.from_numpy(np.array(a))
    k_mask, k_sel, k_dn, k_drop = jax.random.split(key, 4)
    h, w = jcfg.pad_shape
    k_apply, k_d, k_sh, k_sw = jax.random.split(k_mask, 4)
    d = jax.random.randint(k_d, (), 2, h)
    grid = GridDraw(T(bool(jax.random.uniform(k_apply) <= 0.7)),
                    T(int(d)), T(int(jax.random.randint(k_sh, (), 0, d))),
                    T(int(jax.random.randint(k_sw, (), 0, d))))
    bb = jcfg.backbone
    bn, hw = b * n, (h // bb.patch_size) * (w // bb.patch_size)
    rng, gumbel, dp = k_sel, [], {}
    dprs = drop_path_rates(bb)
    for i in range(bb.depth):
        if i in bb.pruning_loc:
            rng, sel = jax.random.split(rng)
            gumbel.append(T(jax.random.gumbel(sel, (bn, hw, 2), jnp.float32)))
        if not bb.block_is_accelerated(i) and dprs[i] > 0:
            brng = jax.random.fold_in(rng, 1000 + i)
            dp[i] = tuple(T(jax.random.bernoulli(
                jax.random.fold_in(brng, j), 1 - dprs[i], (bn, 1, 1, 1)))
                .reshape(bn) for j in (0, 1))
    hc = jcfg.head
    dn = T(jax.random.uniform(k_dn, (b, hc.scalar, hc.dn_max_gt, 3),
                              jnp.float32, -1.0, 1.0))
    nq, nks, nkc = tt.decoder_shapes(get_config("tiny"), b, n)
    shapes = {"self_attn": (b, hc.decoder.num_heads, nq, nks),
              "cross_attn": (b, hc.decoder.num_heads, nq, nkc),
              "res": (b, nq, hc.embed_dims),
              "ffn0": (b, nq, hc.decoder.feedforward_channels)}
    keep = 1 - hc.decoder.dropout
    bern = lambda k, s: T(jax.random.bernoulli(k, keep, s))
    dropout = []
    for li in range(hc.decoder.num_layers):
        r = lambda i: jax.random.fold_in(jax.random.fold_in(k_drop, li), i)
        dropout.append({
            "self_attn": bern(r(3), shapes["self_attn"]),
            "res0": bern(jax.random.fold_in(r(0), 0), shapes["res"]),
            "cross_attn": bern(r(4), shapes["cross_attn"]),
            "res1": bern(jax.random.fold_in(r(1), 1), shapes["res"]),
            "ffn0": bern(jax.random.fold_in(r(2), 0), shapes["ffn0"]),
            "ffn1": bern(jax.random.fold_in(r(2), 1), shapes["res"])})
    return tt.TrainNoise(grid, gumbel, dn, dp, dropout)


def rel_close(got, ref, rel, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def one_step():
    """Two steps on each side from the same weights: the first frame of a
    scene (prev_exists 0, an empty bank), then the next frame (prev_exists
    1) on the bank the first left, which reaches what the first cannot
    (the selectors' query scores, the bank's MLNs, the self-attention's
    values). Snapshots after each step: metrics, parameters, first
    moment, bank."""
    jcfg = _with_droppath(jax_get_config("tiny"))
    tcfg = _with_droppath(get_config("tiny"))
    params = jax.jit(lambda k: init_detector(k, jcfg))(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    b, n = 2, 2
    batches = [make_batch(np.random.RandomState(s), b, n, *jcfg.pad_shape)
               for s in (0, 1)]
    batches[1]["prev_exists"][:] = 1.0
    batches[1]["timestamp"][:] = 1.0
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    tx = jt.make_optimizer(params, total_iters=100)
    state = jt.init_train_state(params, tx, b, jcfg)
    jstep = jax.jit(jt.make_train_step(jcfg, tx))
    jax_out = []
    jax_assigner.set_default_impl("callback")
    try:
        for bt, key in zip(batches, keys):
            state, metrics = jstep(
                state, jax.tree_util.tree_map(jnp.asarray, bt), key)
            jax_out.append(dict(
                state=state, metrics={k: float(v) for k, v in
                                      metrics.items()},
                mu=jax_first_moment(state.opt_state, tcfg)))
    finally:
        jax_assigner.set_default_impl(None)
    model = build_detector(tcfg, device="cpu",
                           state_dict=params_from_jax(params_np, tcfg))
    ttx = tt.make_optimizer(model, total_iters=100)
    tstate = tt.init_train_state(model, ttx, b)
    tstep = tt.make_train_step(ttx)
    port_out = []
    for bt, key in zip(batches, keys):
        tb, steady = tt.batch_to_device(bt, "cpu")
        tstate, tmetrics = tstep(tstate, tb, jax_noise(jcfg, key, b, n),
                                 steady=steady)
        port_out.append(dict(
            metrics={k: float(v) for k, v in tmetrics.items()},
            params={k: v.clone() for k, v in model.state_dict().items()},
            mu=dict(zip(ttx.names, (m.clone() for m in
                                    tstate.opt_state["mu"]))),
            memory=tstate.memory, step=tstate.step))
    return dict(jax=jax_out, port=port_out, tcfg=tcfg, params_np=params_np,
                lr0=float(tt.make_lr_schedule(total_iters=100)(0)))


def jax_first_moment(opt_state, tcfg):
    """JAX's AdamW first moment after the step, by the port's parameter
    names: the backbone's and the rest's (multi_transform masks each to
    its group) merged into one tree."""
    isn = lambda x: isinstance(x, optax.MaskedNode)
    a, b = (mu for _, mu in
            optax.tree_utils.tree_get_all_with_path(opt_state, "mu"))
    merged = jax.tree_util.tree_map(lambda x, y: y if isn(x) else x, a, b,
                                    is_leaf=isn)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, merged), tcfg)


def _metrics_match(jm, tm):
    assert set(tm) == set(jm), set(tm) ^ set(jm)
    for k in sorted(jm):
        rel_close(tm[k], jm[k], 1e-4, k)
    assert tm["nonfinite_skips"] == 0 and tm["total_loss"] > 0
    assert "semantic_loss" in tm and "dn_loss_cls" in tm


def test_train_step_losses_and_grad_norm_match_jax(one_step):
    _metrics_match(one_step["jax"][0]["metrics"],
                   one_step["port"][0]["metrics"])


def test_train_step_second_frame_losses_match_jax(one_step):
    """The next frame, on the bank the first step left."""
    _metrics_match(one_step["jax"][1]["metrics"],
                   one_step["port"][1]["metrics"])


def _frame_grads(out, t):
    """The clipped gradient of step t from AdamW's first moments:
    mu_t = b1 mu_(t-1) + (1 - b1) g_t, b1 0.9, mu_(-1) = 0."""
    mu = {k: np.asarray(v, np.float64) for k, v in out[t]["mu"].items()}
    if t == 0:
        return {k: v / 0.1 for k, v in mu.items()}
    prev = out[t - 1]["mu"]
    return {k: (v - 0.9 * np.asarray(prev[k], np.float64)) / 0.1
            for k, v in mu.items()}


@pytest.mark.parametrize("frame", [0, 1])
def test_train_step_gradients_match_jax(one_step, frame):
    """Every parameter's gradient, element by element, read from AdamW's
    first moments on both sides: the whole step's (selectors, the
    token-selection loss, the training blend, the gumbel mask, the
    stochastic-depth block, the kernels' Functions, the head, DN) within
    1e-4 relative and 1e-4 of each tensor's largest (at the second step,
    its largest over both steps). The first frame
    leaves the selectors' query path and the bank's MLNs without a
    gradient (an empty bank); the second reaches them."""
    want = _frame_grads(one_step["jax"], frame)
    got = _frame_grads(one_step["port"], frame)
    prev = _frame_grads(one_step["jax"], 0) if frame else want
    assert set(got) == set(want)
    for k in sorted(want):
        # the second step's gradient is a difference of f32 moments, whose
        # rounding scales with the first step's: the scale is the larger
        scale = max(np.abs(want[k]).max(), np.abs(prev[k]).max(), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    live = {k for k, v in want.items() if np.abs(v).max() > 0}
    assert len(live) > 0.8 * len(want), len(live)
    if frame == 1:
        for k in ("img_backbone.score_predictor.0.query_embedding.0.weight",
                  "img_backbone.score_predictor.0.ego_pose_queries.gamma."
                  "weight",
                  "pts_bbox_head.ego_pose_memory.gamma.weight",
                  "pts_bbox_head.transformer.decoder.layers.0.attentions.0."
                  "attn.in_proj_weight"):
            assert k in live, k


def test_train_step_updated_params_match_jax(one_step):
    """Within 1e-5, save where the gradient is rounding: an element whose
    gradient is at most 1e-6 of its tensor's largest on both sides (the key
    projection's bias, whose gradient is 0 but for rounding, is the usual
    one). The first AdamW step, g / (|g| + 1e-8), gives such a gradient a
    step of up to lr either way, so there the bound is that step,
    2 lr (1 + wd |p|), and at most 1e-4 of all elements may use it. The
    gradients themselves are held in the test above."""
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, one_step["jax"][0]["state"].params), one_step["tcfg"])
    got = one_step["port"][0]["params"]
    before = params_from_jax(one_step["params_np"], one_step["tcfg"])
    mu_t, mu_j = one_step["port"][0]["mu"], one_step["jax"][0]["mu"]
    assert set(got) == set(want)
    moved = loose = total = 0
    for k in sorted(want):
        w, p0 = want[k].numpy(), before[k].numpy()
        d = np.abs(got[k].numpy() - w)
        over = d > 1e-5
        if over.any():
            gj, gt = np.abs(mu_j[k].numpy()), np.abs(mu_t[k].numpy())
            rounding = (gj <= 1e-6 * gj.max()) & (gt <= 1e-6 * gt.max())
            assert rounding[over].all(), (k, d[over & ~rounding].max())
            bound = 2 * one_step["lr0"] * (1 + 0.01 * np.abs(p0)) + 1e-5
            assert (d[over] <= bound[over]).all(), k
        loose += int(over.sum())
        total += d.size
        moved += not torch.equal(got[k], before[k])
    assert moved > 0.9 * len(want), moved
    assert loose <= 1e-4 * total, (loose, total)


def test_train_step_bank_matches_jax(one_step):
    jmem = one_step["jax"][0]["state"].memory
    port = one_step["port"][0]
    for name in BANK:
        np.testing.assert_allclose(
            getattr(port["memory"], name).numpy(),
            np.asarray(getattr(jmem, name)), atol=1e-3, err_msg=name)
    assert port["step"] == 1
    assert not port["memory"].embedding.requires_grad


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_optax():
    sched = tt.make_lr_schedule(1e-4, warmup_iters=500, total_iters=10_000)
    ref = jt.make_lr_schedule(1e-4, warmup_iters=500, total_iters=10_000)
    for s in (0, 250, 500, 10_000):
        np.testing.assert_allclose(float(sched(s)), float(ref(s)),
                                   rtol=1e-6, err_msg=str(s))
    assert float(sched(250)) > float(sched(0))


def test_param_labels_and_backbone_lr_mult():
    """Every parameter labelled, the backbone's (and only those) at lr
    x0.1 (test_train.py:84, :138)."""
    model = build_detector(get_config("tiny"), device="cpu", seed=0)
    tx = tt.make_optimizer(model, base_lr=1e-4, backbone_lr_mult=0.1,
                           warmup_iters=0, total_iters=100_000)
    labels = tt.param_labels(tx.names)
    assert len(labels) == len(list(model.parameters()))
    for n, l in zip(tx.names, labels):
        assert l == ("backbone" if n.startswith("img_backbone.")
                     else "rest"), n
    assert 0 < labels.count("backbone") < len(labels)
    st = tx.init()
    before = [p.detach().clone() for p in tx.params]
    tx.step(st, [torch.ones_like(p) for p in tx.params])
    d = {n: (p.detach() - b).abs().mean().item()
         for n, p, b in zip(tx.names, tx.params, before)}
    u_bb = d["img_backbone.blocks.0.attn.q_proj.weight"]
    u_head = d["pts_bbox_head.reference_points.weight"]
    assert 0.05 < u_bb / u_head < 0.2, (u_bb, u_head)


def test_layer_decay_mults_match_jax():
    """get_vit_lr_decay_rate on the port's names against JAX's on its
    paths (eva_vit.py:574-591; test_train.py:156)."""
    depth, rate = 4, 0.9
    pairs = [("img_backbone.patch_embed.proj.weight",
              "img_backbone/patch_embed/w"),
             ("img_backbone.pos_embed", "img_backbone/pos_embed"),
             ("pts_bbox_head.reference_points.weight",
              "pts_bbox_head/reference_points")]
    pairs += [(f"img_backbone.blocks.{i}.attn.q_proj.weight",
               f"img_backbone/blocks/{i}/attn/q_proj/w")
              for i in range(depth)]
    for tn, jn in pairs:
        assert np.isclose(tt.get_vit_lr_decay_rate(tn, rate, depth),
                          jax_decay(jn, rate, depth)), tn
    m = tt.layer_decay_mults([p[0] for p in pairs], rate, depth)
    assert np.isclose(m[0], rate ** (depth + 1)) and m[2] == 1.0


def test_adamw_matches_optax_chain_and_skips_nonfinite():
    """The port's AdamW (clip 35, two lr groups, weight decay, skip) on a
    toy module against optax's make_optimizer chain over four steps, a
    non-finite one among them: that step moves nothing and counts one
    skip, the next proceeds as if it had not happened (test_train.py:103)."""
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.img_backbone = torch.nn.Linear(3, 4)
            self.head = torch.nn.Linear(4, 2)
    rng = np.random.RandomState(0)
    toy = Toy()
    tx = tt.AdamW(toy, base_lr=1e-3, warmup_iters=2, total_iters=20)
    st = tx.init()
    jparams = {n: jnp.asarray(p.detach().numpy())
               for n, p in toy.named_parameters()}
    sched = jt.make_lr_schedule(1e-3, 2, total_iters=20)
    sched_bb = jt.make_lr_schedule(1e-4, 2, total_iters=20)
    labels = {n: "backbone" if n.startswith("img_backbone") else "rest"
              for n in jparams}
    jtx = jt.skip_on_nonfinite(optax.chain(
        optax.clip_by_global_norm(35.0),
        optax.multi_transform({"backbone": optax.adamw(sched_bb,
                                                        weight_decay=0.01),
                               "rest": optax.adamw(sched, weight_decay=0.01)},
                              labels)))
    jst = jtx.init(jparams)
    for step in range(4):
        g = {n: rng.randn(*p.shape).astype(np.float32) * (30 if step else 1)
             for n, p in jparams.items()}
        if step == 2:
            g["head.bias"][0] = np.nan
        upd, jst = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                              jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = [p.detach().clone() for p in tx.params]
        norm = tx.step(st, [torch.from_numpy(g[n]) for n in tx.names])
        if step == 2:
            assert not np.isfinite(float(norm))
            assert all(torch.equal(a, p) for a, p in zip(before, tx.params))
        for n, p in zip(tx.names, tx.params):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[n]), atol=1e-7,
                                       rtol=1e-6, err_msg=f"{step} {n}")
    assert int(st["notfinite"]) == 1 == int(jst.total_notfinite)
    assert int(st["count"]) == 3


def test_nonfinite_batch_leaves_params_unchanged():
    """A full tiny step on a batch with a NaN image: no parameter moves and
    nonfinite_skips counts one."""
    cfg = get_config("tiny")
    model = build_detector(cfg, device="cpu", seed=0)
    tx = tt.make_optimizer(model, total_iters=100)
    state = tt.init_train_state(model, tx, 1)
    batch = make_batch(np.random.RandomState(3), 1, 2, *cfg.pad_shape)
    batch["img"][0, 0, 5, 5, 0] = np.nan
    tb, steady = tt.batch_to_device(batch, "cpu")
    noise = tt.draw_train_noise(cfg, 1, 2, torch.Generator().manual_seed(0),
                                "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = tt.make_train_step(tx)(state, tb, noise, steady=steady)
    assert int(m["nonfinite_skips"]) == 1
    assert not np.isfinite(float(m["grad_norm"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(state.opt_state["count"]) == 0


# ---------------------------------------------------------------------------
# save / resume
# ---------------------------------------------------------------------------

def test_save_and_resume_is_exact(tmp_path):
    """Two steps, save, load into a fresh state, one step: exactly what
    three uninterrupted steps give (parameters, moments, counters, bank)."""
    cfg = get_config("tiny")
    rng = np.random.RandomState(7)
    batches = [make_batch(rng, 1, 2, *cfg.pad_shape) for _ in range(3)]
    for bt in batches[1:]:
        bt["prev_exists"][:] = 1.0

    def run(state, tx, steps):
        fn = tt.make_train_step(tx)
        for s in steps:
            tb, steady = tt.batch_to_device(batches[s], "cpu")
            noise = tt.draw_train_noise(cfg, 1, 2,
                                        torch.Generator().manual_seed(s),
                                        "cpu")
            state, _ = fn(state, tb, noise, steady=steady)
        return state

    def fresh():
        model = build_detector(cfg, device="cpu", seed=0)
        tx = tt.make_optimizer(model, total_iters=50)
        return tt.init_train_state(model, tx, 1), tx

    s_ref, tx_ref = fresh()
    s_ref = run(s_ref, tx_ref, range(3))
    s_a, tx_a = fresh()
    s_a = run(s_a, tx_a, range(2))
    path = save_train_state(s_a, tx_a, str(tmp_path / "iter_2.pth"))
    s_b, tx_b = fresh()
    s_b = load_train_state(path, s_b, tx_b)
    assert s_b.step == 2
    s_b = run(s_b, tx_b, [2])
    ref_sd = s_ref.model.state_dict()
    for k, v in s_b.model.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k
    for k in ("mu", "nu"):
        for a, b in zip(s_b.opt_state[k], s_ref.opt_state[k]):
            assert torch.equal(a, b)
    for k in ("count", "notfinite"):
        assert torch.equal(s_b.opt_state[k], s_ref.opt_state[k])
    for a, b in zip(s_b.memory, s_ref.memory):
        assert torch.equal(a, b)
