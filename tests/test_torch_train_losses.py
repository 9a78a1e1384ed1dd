"""The port's training losses and their inputs against the JAX package on
the CPU in f32: the loss primitives (core/losses.py), the Hungarian
matching (core/assigner.py: costs on the tensors' device, scipy on the
host), DN preparation (core/dn.py) and the grid mask given JAX's own draws,
the FocalHead forward and its loss, and the StreamPETR set and DN losses.

Each value within 1e-5 relative; matched indices, DN masks, known labels,
the grid mask and the focal ranking equal exactly. Inputs are numpy draws
from a seed; parameters come from JAX's tree through the port's converter.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.core import assigner as ja
from toc3d_tpu.core import dn as jdn
from toc3d_tpu.core import losses as jl
from toc3d_tpu.core.boxes import normalize_bbox
from toc3d_tpu.models import focal_head as jfh
from toc3d_tpu.models import grid_mask as jgm
from toc3d_tpu.models.focal_head_loss import focal_head_loss as jax_fhl
from toc3d_tpu.models.streampetr_head import location_grid as jax_locs
from toc3d_tpu.models.streampetr_loss import streampetr_loss as jax_spl

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.convert import _Out
from toc3d_tpu_torch.core import assigner as ta
from toc3d_tpu_torch.core import dn as tdn
from toc3d_tpu_torch.core import losses as tl
from toc3d_tpu_torch.models.focal_head import (FocalHeadParams,
                                               focal_head_forward)
from toc3d_tpu_torch.models.focal_head_loss import focal_head_loss
from toc3d_tpu_torch.models.grid_mask import GridDraw, grid_mask
from toc3d_tpu_torch.models.streampetr_head import location_grid
from toc3d_tpu_torch.models.streampetr_loss import streampetr_loss


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rel=1e-5, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale,
                               err_msg=name)


def _boxes3d(rng, b, g):
    boxes = rng.randn(b, g, 9).astype(np.float32) * 5
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1.0
    return boxes


def _boxes2d(rng, v, g, scale=60.0):
    xy = np.sort(rng.rand(v, g, 2, 2).astype(np.float32) * scale, axis=-2)
    return xy.reshape(v, g, 4)


# ---------------------------------------------------------------------------
# loss primitives
# ---------------------------------------------------------------------------

def test_focal_qfl_l1_giou_kl_match_jax():
    rng = np.random.RandomState(0)
    n, c = 40, 10
    pred = rng.randn(n, c).astype(np.float32) * 3
    labels = rng.randint(0, c + 1, n)
    onehot = np.eye(c + 1, dtype=np.float32)[labels][:, :c]
    w = (rng.rand(n) > 0.2).astype(np.float32)
    close(tl.sigmoid_focal_loss(T(pred), T(onehot), T(w), 7.0),
          jl.sigmoid_focal_loss(pred, onehot, w, 7.0), name="focal")
    q = rng.rand(n).astype(np.float32)
    close(tl.quality_focal_loss(T(pred), T(labels), T(q), T(w), 5.0, c),
          jl.quality_focal_loss(pred, labels, q, w, 5.0, c), name="qfl")
    a, t = (rng.randn(n, 4).astype(np.float32) for _ in range(2))
    close(tl.l1_loss(T(a), T(t), T(w[:, None]), T(np.float32(3.0))),
          jl.l1_loss(a, t, w[:, None], 3.0), name="l1")
    pa, pb = _boxes2d(rng, 1, n)[0], _boxes2d(rng, 1, n)[0]
    close(tl.giou_loss(T(pa), T(pb), T(w), 4.0),
          jl.giou_loss(pa, pb, w, 4.0), name="giou")
    close(tl.bbox_overlaps_aligned(T(pa), T(pb)),
          jl.bbox_overlaps_aligned(pa, pb), name="iou")
    lp = np.log(np.abs(rng.randn(n, c)).astype(np.float32) + 0.1)
    tp = rng.rand(n, c).astype(np.float32)
    close(tl.kl_div_loss(T(lp), T(tp)), jl.kl_div_loss(lp, tp), name="kl")
    close(tl.kl_div_loss(T(lp), T(tp), T(w[:, None]), 2.0),
          jl.kl_div_loss(lp, tp, w[:, None], 2.0), name="kl weighted")


def test_gaussian_focal_and_token_selection_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.rand(3, 5, 8).astype(np.float32)
    pred[0, 0, :3] = (0.0, 1.0, 0.5)       # the clipped endpoints
    target = rng.rand(3, 5, 8).astype(np.float32)
    target[1, 1, :4] = 1.0
    w = np.ones_like(pred)
    close(tl.gaussian_focal_loss(T(pred), T(target), T(w)),
          jl.gaussian_focal_loss(pred, target, w), name="mean")
    close(tl.gaussian_focal_loss(T(pred), T(target), T(w), 9.0),
          jl.gaussian_focal_loss(pred, target, w, 9.0), name="avg")
    v, g, h, wd = 4, 5, 6, 10
    boxes = _boxes2d(rng, v, g, 150.0)
    valid = rng.rand(v, g) > 0.3
    masks = rng.rand(2, v, h, wd).astype(np.float32)
    np.testing.assert_array_equal(
        tl.token_selection_targets(T(boxes), T(valid), h, wd).numpy(),
        np.asarray(jl.token_selection_targets(boxes, valid, h, wd)))
    close(tl.token_selection_loss(T(masks), T(boxes), T(valid)),
          jl.token_selection_loss(masks, boxes, valid), name="tsl")


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def test_assign_3d_matches_jax():
    rng = np.random.RandomState(2)
    b, q, g, c = 2, 30, 6, 10
    bbox = rng.randn(b, q, 10).astype(np.float32)
    cls = rng.randn(b, q, c).astype(np.float32)
    gt = _boxes3d(rng, b, g)
    labels = rng.randint(0, c, (b, g))
    valid = np.ones((b, g), bool)
    valid[1, 4:] = False
    cw = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    cost = ta.cost_3d(T(bbox), T(cls), T(gt), T(labels), T(valid), cw)
    ref_cost = []
    mc = jnp.asarray(cw)
    for i in range(b):
        # assign_3d's per-sample cost (assigner.py:149-158), no velocity
        cc = ja.focal_cls_cost(jnp.asarray(cls[i]), jnp.asarray(labels[i]))
        reg = ja.l1_cost((jnp.asarray(bbox[i]) * mc)[:, :8],
                         (normalize_bbox(jnp.asarray(gt[i])) * mc)[:, :8],
                         0.25)
        ref_cost.append(np.asarray(cc + reg))
    ref_cost = np.stack(ref_cost)
    close(cost.numpy()[valid[:, None, :].repeat(q, 1)],
          ref_cost[valid[:, None, :].repeat(q, 1)], name="cost")
    ja.set_default_impl("callback")
    try:
        want = np.asarray(ja.assign_3d(jnp.asarray(bbox), jnp.asarray(cls),
                                       jnp.asarray(gt), jnp.asarray(labels),
                                       jnp.asarray(valid), cw))
    finally:
        ja.set_default_impl(None)
    got = ta.assign_3d(T(bbox), T(cls), T(gt), T(labels), T(valid), cw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[valid] >= 0).all() and (got.numpy()[~valid] == -1
                                                ).all()


def test_assign_2d_and_one_round_trip_match_jax():
    """The 2D assignment, and hungarian_match solving a 3D and a 2D problem
    in one host round trip with the same answers as each alone."""
    rng = np.random.RandomState(3)
    v, q, g, c = 3, 40, 5, 10
    bp = rng.rand(v, q, 4).astype(np.float32) * 0.5 + 0.1
    cp = rng.randn(v, q, c).astype(np.float32)
    ctp = rng.rand(v, q, 2).astype(np.float32)
    gb = _boxes2d(rng, v, g, 100.0)
    gl = rng.randint(0, c, (v, g))
    gc = rng.rand(v, g, 2).astype(np.float32) * 100
    gv = rng.rand(v, g) > 0.3
    ja.set_default_impl("callback")
    try:
        want = np.asarray(ja.assign_2d(*(jnp.asarray(a) for a in (
            bp, cp, ctp, gb, gl, gc, gv)), (128, 64)))
    finally:
        ja.set_default_impl(None)
    args = [T(a) for a in (bp, cp, ctp, gb, gl, gc, gv)]
    np.testing.assert_array_equal(ta.assign_2d(*args, (128, 64)).numpy(),
                                  want)
    c2 = ta.cost_2d(*args, (128, 64))
    b3, q3 = 2, 12
    bbox = T(rng.randn(b3, q3, 10).astype(np.float32))
    cls = T(rng.randn(b3, q3, c).astype(np.float32))
    gt, lab = T(_boxes3d(rng, b3, 4)), T(rng.randint(0, c, (b3, 4)))
    val = torch.ones(b3, 4, dtype=torch.bool)
    c3 = ta.cost_3d(bbox, cls, gt, lab, val, (1.0,) * 10)
    both = ta.hungarian_match([(c3, val), (c2, args[-1])])
    np.testing.assert_array_equal(both[1].numpy(), want)
    np.testing.assert_array_equal(
        both[0].numpy(), ta.assign_3d(bbox, cls, gt, lab, val,
                                      (1.0,) * 10).numpy())


# ---------------------------------------------------------------------------
# DN and the grid mask, given JAX's draws
# ---------------------------------------------------------------------------

def test_prepare_for_dn_given_jax_draw():
    jcfg = jax_get_config("tiny").head
    tcfg = get_config("tiny").head
    rng = np.random.RandomState(4)
    b, g = 2, jcfg.dn_max_gt
    gt = _boxes3d(rng, b, g)
    labels = rng.randint(0, 10, (b, g))
    valid = np.ones((b, g), bool)
    valid[0, 2:] = False
    key = jax.random.PRNGKey(5)
    want = jdn.prepare_for_dn(key, jcfg, jnp.asarray(gt),
                              jnp.asarray(labels), jnp.asarray(valid))
    draw = np.asarray(jax.random.uniform(key, (b, jcfg.scalar, g, 3),
                                         jnp.float32, -1.0, 1.0))
    got = tdn.prepare_for_dn(tcfg, T(gt), T(labels), T(valid), T(draw))
    assert got["pad_size"] == want["pad_size"]
    for k in ("attn_mask", "known_labels", "known_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    close(got["known_ref"], want["known_ref"], name="known_ref")
    close(got["known_bboxs"], want["known_bboxs"], name="known_bboxs")
    refs = rng.rand(tcfg.num_query, 3).astype(np.float32)
    close(tdn.dn_reference_points(got, T(refs), b),
          jdn.dn_reference_points(want, jnp.asarray(refs), b), name="refs")


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_grid_mask_given_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 64, 128, 3).astype(np.float32)
    want = np.asarray(jgm.grid_mask(key, jnp.asarray(x)))
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    h = x.shape[-3]
    apply = jax.random.uniform(k_apply) <= 0.7
    d = jax.random.randint(k_d, (), 2, h)
    draw = GridDraw(torch.tensor(bool(apply)), torch.tensor(int(d)),
                    torch.tensor(int(jax.random.randint(k_sh, (), 0, d))),
                    torch.tensor(int(jax.random.randint(k_sw, (), 0, d))))
    np.testing.assert_array_equal(grid_mask(T(x), draw).numpy(), want)


# ---------------------------------------------------------------------------
# FocalHead, its loss, the StreamPETR loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def focal():
    jcfg = jax_get_config("tiny")
    p = jfh.init_focal_head(jax.random.PRNGKey(0), jcfg.focal)
    rng = np.random.RandomState(8)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.randn(
        *a.shape).astype(np.float32) * 0.05, p)
    o = _Out()
    o.conv("shared_cls.0", p["shared_cls_conv"])
    o.ln("shared_cls.1", p["shared_cls_gn"])
    o.conv("shared_reg.0", p["shared_reg_conv"])
    o.ln("shared_reg.1", p["shared_reg_gn"])
    for n in ("cls", "centerness", "ltrb", "center2d"):
        o.conv(n, p[n])
    tcfg = get_config("tiny")
    head = FocalHeadParams(tcfg.focal)
    head.load_state_dict(o.sd)
    b, n = 2, 3
    h, w = jcfg.pad_shape[0] // 16, jcfg.pad_shape[1] // 16
    feats = rng.randn(b, n, h, w, jcfg.focal.in_channels).astype(np.float32)
    jl_ = jax_locs(h, w, 16, *jcfg.pad_shape)
    want = jax.jit(lambda p_, f_: jfh.focal_head_forward(
        p_, jcfg.focal, f_, jl_, 1.0))(jax.tree_util.tree_map(jnp.asarray, p),
                                       jnp.asarray(feats))
    got = focal_head_forward(head, tcfg.focal, T(feats),
                             location_grid(h, w, 16, *tcfg.pad_shape,
                                           device="cpu"), 1.0)
    return jcfg, tcfg, want, got, rng, b, n


def test_focal_head_forward_matches_jax(focal):
    _, _, want, got, *_ = focal
    for k in ("enc_cls_scores", "enc_bbox_preds", "pred_centers2d",
              "centerness"):
        close(got[k], want[k], name=k)
    np.testing.assert_array_equal(got["topk_indexes"].numpy(),
                                  np.asarray(want["topk_indexes"]))


def test_focal_head_loss_matches_jax(focal):
    jcfg, tcfg, want, got, rng, b, n = focal
    v, g = b * n, 6
    gb = _boxes2d(rng, v, g, 60.0)
    gl = rng.randint(0, 10, (v, g))
    gc = ((gb[..., :2] + gb[..., 2:]) / 2).astype(np.float32)
    gv = rng.rand(v, g) > 0.25
    ja.set_default_impl("callback")
    try:
        ref = jax.jit(lambda w_, *a: jax_fhl(jcfg.focal, w_, *a,
                                             jcfg.pad_shape))(
            want, *(jnp.asarray(a) for a in (gb, gl, gc, gv)))
    finally:
        ja.set_default_impl(None)
    out = focal_head_loss(tcfg.focal, got, *(T(a) for a in (gb, gl, gc, gv)),
                          tcfg.pad_shape)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], name=k)


def test_streampetr_loss_matches_jax():
    jcfg = jax_get_config("tiny").head
    tcfg = get_config("tiny").head
    rng = np.random.RandomState(9)
    L, b, q, c, g = 2, 2, 20, 10, jcfg.dn_max_gt
    p = jcfg.scalar * g
    outs = {"all_cls_scores": rng.randn(L, b, q, c).astype(np.float32),
            "all_bbox_preds": rng.randn(L, b, q, 10).astype(np.float32),
            "dn_cls_scores": rng.randn(L, b, p, c).astype(np.float32),
            "dn_bbox_preds": rng.randn(L, b, p, 10).astype(np.float32)}
    gt = _boxes3d(rng, b, g)
    labels = rng.randint(0, c, (b, g))
    valid = np.ones((b, g), bool)
    valid[1, 3:] = False
    key = jax.random.PRNGKey(2)
    jdnd = jdn.prepare_for_dn(key, jcfg, jnp.asarray(gt),
                              jnp.asarray(labels), jnp.asarray(valid))
    draw = np.asarray(jax.random.uniform(key, (b, jcfg.scalar, g, 3),
                                         jnp.float32, -1.0, 1.0))
    tdnd = tdn.prepare_for_dn(tcfg, T(gt), T(labels), T(valid), T(draw))
    ja.set_default_impl("callback")
    try:
        ref = jax.jit(lambda o_, *a: jax_spl(jcfg, o_, *a, dn=jdnd))(
            jax.tree_util.tree_map(jnp.asarray, outs), jnp.asarray(gt),
            jnp.asarray(labels), jnp.asarray(valid))
    finally:
        ja.set_default_impl(None)
    out = streampetr_loss(tcfg, {k: T(v) for k, v in outs.items()}, T(gt),
                          T(labels), T(valid), dn=tdnd)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], name=k)
