"""The port's configurations and the eval-time paths they open, against the
JAX package on the CPU in f32:

- every preset of toc3d_tpu/configs/presets.py and the ToC3D_ratio* sweep
  names, field by field on the fields the port carries, and
  apply_overrides;
- the plain EVA-02 backbone of the StreamPETR presets, in a tiny detector
  (depth 4, global layers 1 and 3) streamed over 3 frames with a scene
  reset, its weights from JAX's tree through convert.params_from_jax;
- a tiny ViT-B-shaped ToC3D (width 48 in 3 heads, SwiGLU hidden 128 with
  no padding, 8 blocks, selectors at depth 1/4, 1/2, 3/4);
- the reference's eval masks: eval_mask 'gumbel' with JAX's own noise
  handed to the port (JAX's per-frame keys, fold_in(PRNGKey(mask_seed), t),
  split once per selector), and 'hard', per selector and end to end.

Inputs are numpy draws from a seed; weights come from the reference-named
state dict of tests/test_full_converter.py. Tolerances as
tests/test_parity_detector.py: scores, boxes and the memory bank 1e-3,
labels and validity equal."""
import dataclasses
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import presets as jax_presets
from toc3d_tpu.models import token_select as jax_ts
from toc3d_tpu.models.detector import infer_step as jax_infer_step
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.models.detector import make_infer_fn as jax_make_infer_fn
from toc3d_tpu.models.eva_vit import EVAViTConfig as JaxEVAViTConfig
from toc3d_tpu.models.toc3d_vit import ToC3DViTConfig as JaxToC3DViTConfig
from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint

from test_full_converter import build_reference_state_dict
from test_parity_detector import make_frames

from toc3d_tpu_torch.configs import presets
from toc3d_tpu_torch.convert import params_from_jax
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.models import token_select as ts
from toc3d_tpu_torch.models.eva_vit import EVAViT, EVAViTConfig
from toc3d_tpu_torch.models.streampetr_head import MemoryBank
from toc3d_tpu_torch.models.toc3d_vit import ToC3DViT, ToC3DViTConfig

BANK = ("embedding", "reference_point", "timestamp", "egopose", "velo")
NAMES = sorted(jax_presets.PRESETS) + ["ToC3D_ratio543",
                                       "ToC3D_ratio755_1600"]


def _same_fields(port, ref, path="cfg"):
    """Every field of the port's config equals the JAX config's field of
    the same name; nested configs are compared the same way."""
    assert type(port).__name__ == type(ref).__name__, path
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, where)
        elif isinstance(a, (tuple, list)):
            assert tuple(a) == tuple(b), where
        else:
            assert a == b and type(a) is type(b), (where, a, b)


def test_preset_names_are_jax_names():
    assert set(presets.PRESETS) == set(jax_presets.PRESETS)


@pytest.mark.parametrize("name", NAMES)
def test_preset_equals_jax(name):
    _same_fields(presets.get_config(name), jax_presets.get_config(name))
    _same_fields(presets.get_config(name, compute_dtype="float32"),
                 jax_presets.get_config(name, compute_dtype="float32"))


def test_plain_presets_build_the_plain_backbone():
    """The StreamPETR presets dispatch to the plain backbone, which has no
    selectors, as JAX's is_toc3d does; the ToC3D ones keep theirs."""
    for name in NAMES:
        cfg = presets.get_config(name)
        assert cfg.is_toc3d == jax_presets.get_config(name).is_toc3d, name
        assert cfg.is_toc3d == (not name.startswith("stream_petr")), name
    with torch.device("meta"):
        plain = td.ToC3DDetector(presets.get_config("stream_petr_vit_b"))
        comp = td.ToC3DDetector(presets.get_config("ToC3D_vit_b_fast"))
    assert type(plain.img_backbone) is EVAViT
    assert not any("score_predictor" in k for k in plain.state_dict())
    assert type(comp.img_backbone) is ToC3DViT
    assert len(comp.img_backbone.score_predictor) == 3
    assert plain.img_neck.lateral_convs[0].conv.in_channels == 768


@pytest.mark.parametrize("options", [
    ["head.num_query=900", "backbone.token_ratio=(0.5,0.4,0.3)"],
    ["backbone.eval_mask=gumbel", "head.decoder.num_layers=3"],
    ["compute_dtype='float32'", "backbone.pruning_loc=(6,)",
     "backbone.token_ratio=(0.7,)"],
])
def test_apply_overrides_equals_jax(options):
    _same_fields(
        presets.apply_overrides(presets.get_config("ToC3D_faster"), options),
        jax_presets.apply_overrides(jax_presets.get_config("ToC3D_faster"),
                                    options))


def test_unknown_names_raise():
    for name in ("ToC3D_fastest", "ToC3D_ratio54", "ToC3D_ratio5x3"):
        with pytest.raises(KeyError):
            presets.get_config(name)


# ---------------------------------------------------------------------------
# streaming against JAX
# ---------------------------------------------------------------------------

_TINY_VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=4,
                 num_heads=2, window_size=4, global_window_size=4,
                 global_attn_indexes=(1, 3), pretrain_img_size=32)


def _toc3d(mod, **kw):
    """A tiny ToC3DViTConfig of ``mod`` (the JAX or the port's class)."""
    base = dict(_TINY_VIT, pruning_num_queries=4, query_dim=64,
                pc_range=presets.POINT_CLOUD_RANGE, mxu_align_k=True)
    base.update(kw)
    return mod(**base)


def _tiny(backbone_jax, backbone_port, neck_in=64):
    """The JAX and port `tiny` detector configs around the given
    backbones."""
    jcfg = jax_presets.get_config("tiny")
    jcfg = replace(jcfg, backbone=backbone_jax,
                   neck=replace(jcfg.neck, in_channels=(neck_in,)))
    tcfg = presets.get_config("tiny")
    tcfg = replace(tcfg, backbone=backbone_port,
                   neck=replace(tcfg.neck, in_channels=(neck_in,)))
    _same_fields(tcfg, jcfg)
    return jcfg, tcfg


def _reference_dict(jcfg, rng):
    """The reference-named state dict of ``jcfg``; a plain backbone's is
    drawn through a ToC3D twin without selectors, which has the same
    keys."""
    b = jcfg.backbone
    if not isinstance(b, JaxToC3DViTConfig):
        twin = JaxToC3DViTConfig(
            **{f.name: getattr(b, f.name) for f in dataclasses.fields(b)},
            pruning_loc=(), token_ratio=())
        jcfg = replace(jcfg, backbone=twin)
    return build_reference_state_dict(jcfg, rng)


def _compare(t, tdet, jdet, tstate, jstate):
    """Scores by rank at 1e-3; each box, label and validity at its rank,
    except that ranks whose JAX scores lie within 1e-6 of the port's
    score are near ties (random weights score every query alike, to 1e-5,
    and a last-bit difference orders such ranks either way): the port's
    box must then equal the box of one of them. The bank at 1e-3."""
    msg = f"frame {t}"
    ts, js = tdet.scores[0].numpy(), np.asarray(jdet.scores[0])
    np.testing.assert_allclose(ts, js, atol=1e-3, err_msg=f"{msg} scores")
    tb, jb = tdet.bboxes[0].numpy(), np.asarray(jdet.bboxes[0])
    tl, jl = tdet.labels[0].numpy(), np.asarray(jdet.labels[0])
    tv, jv = tdet.valid[0].numpy(), np.asarray(jdet.valid[0])
    for i in range(len(ts)):
        tied = np.flatnonzero(np.abs(js - ts[i]) <= 1e-6)
        assert any(np.allclose(tb[i], jb[j], atol=1e-3, rtol=1e-3)
                   and tl[i] == jl[j] and tv[i] == jv[j]
                   for j in sorted(tied, key=lambda j: abs(j - i))), \
            f"{msg} box {i}: {tb[i]} against {jb[i]}"
    # the bank: slot by slot at 1e-3, a slot filled from near-tied
    # queries matching one of JAX's slots
    tm = [getattr(tstate.memory, n)[0].reshape(
        tstate.memory.embedding.shape[1], -1).numpy() for n in BANK]
    jm = [np.asarray(getattr(jstate.memory, n)[0]).reshape(len(tm[0]), -1)
          for n in BANK]
    same = lambda i, j: all(np.allclose(a[i], b[j], atol=1e-3, rtol=0)
                            for a, b in zip(tm, jm))
    free = set(range(len(tm[0])))
    for i in range(len(tm[0])):
        j = next((j for j in sorted(free, key=lambda j: abs(j - i))
                  if same(i, j)), None)
        assert j is not None and abs(j - i) <= 2, \
            f"{msg} memory slot {i}: no JAX slot near it matches"
        free.discard(j)


def _stream(jcfg, tcfg, seed, prev=(0.0, 1.0, 0.0), via_jax_tree=False,
            noise=None, from_jax_bank=False):
    """Stream len(prev) frames through JAX (one jitted program, or for
    noise its make_infer_fn) and the port's infer_step, and compare each
    frame. via_jax_tree: the port's weights come from JAX's parameter tree
    through params_from_jax, and the port's key set must be that tree's.
    noise(t, frame) -> the port's mask_noise of frame t. from_jax_bank: the
    port starts each frame from JAX's bank of the frame before (as
    tests/test_torch_int8.py does), instead of carrying its own. Returns
    the model and the port's per-frame scores."""
    rng = np.random.RandomState(seed)
    sd = _reference_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    if via_jax_tree:
        tsd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              jcfg)
        model = td.build_detector(tcfg, device="cpu", state_dict=tsd)
        assert set(tsd) == set(model.state_dict())
    else:
        model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    frames = make_frames(rng, jcfg, t_total=len(prev))
    for f, pe in zip(frames, prev):
        f["prev_exists"] = np.full((1,), pe, np.float32)
    if noise is None:
        jstep = jax.jit(lambda p, s, f: jax_infer_step(p, jcfg, s, f))
        jinfer = lambda s, f: jstep(params, s, f)
    else:
        jfn = jax_make_infer_fn(jcfg, mask_seed=3)
        jinfer = lambda s, f: jfn(params, s, f)
    jstate = jax_init_state(1, jcfg)
    tstate = td.init_state(1, tcfg, device="cpu")
    scores = []
    for t, frame in enumerate(frames):
        if from_jax_bank:
            tstate = td.DetectorState(MemoryBank(*(
                torch.from_numpy(np.array(m)) for m in jstate.memory)))
        jstate, jdet = jinfer(jstate, {k: jnp.asarray(v)
                                       for k, v in frame.items()})
        tf = td.frame_to_device(frame, "cpu")
        tstate, tdet = td.infer_step(
            model, tstate, tf,
            mask_noise=None if noise is None else noise(t, tf))
        _compare(t, tdet, jdet, tstate, jstate)
        scores.append(tdet.scores.numpy())
    return model, scores


@pytest.mark.parametrize("kind", ["EVAViTConfig", "ToC3DViTConfig, no "
                                                  "pruning_loc"])
def test_plain_backbone_detector_matches_jax(kind):
    """The StreamPETR form: the plain backbone (24 B blocks at full size),
    over prev_exists 0, 1, 0. Both packages dispatch a ToC3DViTConfig
    without pruning locations to it as well."""
    if kind == "EVAViTConfig":
        bj, bt = JaxEVAViTConfig(**_TINY_VIT), EVAViTConfig(**_TINY_VIT)
    else:
        bj = _toc3d(JaxToC3DViTConfig, pruning_loc=(), token_ratio=())
        bt = _toc3d(ToC3DViTConfig, pruning_loc=(), token_ratio=())
    jcfg, tcfg = _tiny(bj, bt)
    assert not tcfg.is_toc3d
    model, _ = _stream(jcfg, tcfg, 21, via_jax_tree=True)
    assert not any("score_predictor" in k for k in model.state_dict())


def test_plain_backbone_state_dict_loads_strictly():
    """A reference StreamPETR dict (no score_predictor, no motion parts)
    loads with strict=True, and a selector key is refused."""
    bt = EVAViTConfig(**_TINY_VIT)
    jcfg, tcfg = _tiny(JaxEVAViTConfig(**_TINY_VIT), bt)
    sd = _reference_dict(jcfg, np.random.RandomState(0))
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    assert all(not k.startswith("img_backbone.score_predictor")
               for k in model.state_dict())
    sd["img_backbone.score_predictor.0.aggregate.0.weight"] = np.zeros(
        (2, 4), np.float32)
    with pytest.raises(RuntimeError, match="score_predictor"):
        model.load_state_dict(sd, strict=True)


def test_vit_b_shaped_toc3d_matches_jax():
    """ViT-B's shape at a tiny size: 3 heads of 16 at width 48, so the
    SwiGLU hidden int(48 * 8/3) = 128 needs no padding (ViT-B's 2048, where
    ViT-L pads 2730 to 2736); 8 blocks with global layers 1, 3, 5, 7 and
    selectors at 2, 4, 6 (ViT-B's proportional (3, 6, 9) of 12), ratios
    .7 / .5 / .5."""
    kw = dict(embed_dim=48, num_heads=3, depth=8,
              global_attn_indexes=(1, 3, 5, 7), pruning_loc=(2, 4, 6),
              token_ratio=(0.7, 0.5, 0.5))
    jcfg, tcfg = _tiny(_toc3d(JaxToC3DViTConfig, **kw),
                       _toc3d(ToC3DViTConfig, **kw), neck_in=48)
    assert int(48 * tcfg.backbone.mlp_ratio) % 16 == 0
    _stream(jcfg, tcfg, 23, via_jax_tree=True)


# ---------------------------------------------------------------------------
# eval masks
# ---------------------------------------------------------------------------

# two selectors, so the first one's mask shapes the second one's scores
_MASKED = dict(pruning_loc=(0, 2), token_ratio=(0.5, 0.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_mask_gumbel_matches_jax(dtype):
    """One selector's mask: JAX's soft_mask with a key against the port's
    with that key's Gumbel draw handed in."""
    rng = np.random.RandomState(5)
    pred = jax.nn.log_softmax(jnp.asarray(rng.randn(4, 32, 2), jnp.float32))
    pred = pred.astype(dtype)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.gumbel(key, pred.shape, jnp.float32))
    want = np.asarray(jax_ts.soft_mask(pred, key).astype(jnp.float32))
    tpred = torch.from_numpy(np.array(pred.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = ts.soft_mask(tpred, torch.from_numpy(noise))
    assert got.dtype == tpred.dtype
    # f32 at 1e-3; bf16 within one output rounding step (2^-8, the bf16
    # spacing below 1): the two f32 softmaxes differ in their last bits
    # and may round apart
    tol = dict(atol=1e-3 if dtype == "float32" else 2.0 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    noiseless = np.asarray(jax_ts.soft_mask(pred).astype(jnp.float32))
    np.testing.assert_allclose(ts.soft_mask(tpred).float().numpy(),
                               noiseless, **tol)


def test_hard_mask_matches_jax():
    """One selector's 'hard' mask (toc3d_vit.py:276-281), with tied scores
    among the draws."""
    rng = np.random.RandomState(6)
    scores = np.round(rng.randn(3, 40), 1).astype(np.float32)
    ki = jax_ts.sample_topk(jnp.asarray(scores), 0.4)[2]
    want = jnp.zeros((3, 40, 1)).at[jnp.arange(3)[:, None], ki].set(1.0)
    got = ts.hard_mask(torch.from_numpy(scores), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_draw_uses_its_generator_only():
    """The port's noise: standard Gumbel (mean 0.5772, finite), the same
    for the same seed, and the global generator left as it was."""
    state = torch.random.get_rng_state()
    g = torch.Generator().manual_seed(1)
    a = ts.gumbel_(torch.empty(200000), g)
    b = ts.gumbel_(torch.empty(200000), g.manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.01
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.03
    assert torch.equal(state, torch.random.get_rng_state())


def test_eval_mask_gumbel_matches_jax():
    """JAX's make_infer_fn with mask_seed 3 against the port's infer_step
    given JAX's noise: frame t's key fold_in(PRNGKey(3), t), split once
    per selector, one gumbel draw each. The noise changes the outputs."""
    jcfg, tcfg = _tiny(_toc3d(JaxToC3DViTConfig, eval_mask="gumbel",
                              **_MASKED),
                       _toc3d(ToC3DViTConfig, eval_mask="gumbel", **_MASKED))
    shape = (2, (64 // 16) * (128 // 16), 2)

    def noise(t, frame):
        key = jax.random.fold_in(jax.random.PRNGKey(3), t)
        out = []
        for _ in tcfg.backbone.pruning_loc:
            key, sel = jax.random.split(key)
            out.append(torch.from_numpy(np.array(
                jax.random.gumbel(sel, shape, jnp.float32))))
        return out
    model, noisy = _stream(jcfg, tcfg, 25, noise=noise)
    tstate = td.init_state(1, tcfg, device="cpu")
    rng = np.random.RandomState(25)
    _reference_dict(jcfg, rng)
    f0 = td.frame_to_device(make_frames(rng, jcfg, t_total=1)[0], "cpu")
    _, plain = td.infer_step(model, tstate, f0)
    assert not np.array_equal(plain.scores.numpy(), noisy[0])


def test_eval_mask_hard_matches_jax():
    """'hard' end to end. Its mask is a top-k over the selector scores,
    which read the bank's first slots in order; random weights score the
    bank's candidates alike to a last bit, so a near tie may order two
    slots apart in the packages' banks (the comparison above allows that)
    and then move the next frame's top-k. Each frame therefore starts from
    JAX's bank."""
    jcfg, tcfg = _tiny(_toc3d(JaxToC3DViTConfig, eval_mask="hard",
                              **_MASKED),
                       _toc3d(ToC3DViTConfig, eval_mask="hard", **_MASKED))
    _stream(jcfg, tcfg, 27, from_jax_bank=True)


def test_mask_noise_per_frame_from_seed():
    """make_infer_fn's noise on the CPU: frame t's draw depends on
    (mask_seed, t) only, so two callables with one seed agree frame by
    frame and another seed differs; without 'gumbel' nothing is drawn."""
    cfg = presets.get_config("tiny")
    cfg = replace(cfg, backbone=replace(cfg.backbone, eval_mask="gumbel",
                                        **_MASKED))
    model = td.build_detector(cfg, device="cpu", seed=0)
    a, b, c = (td.MaskNoise(model, s) for s in (3, 3, 4))
    shape = (1, 2, 64, 128, 3)
    for _ in range(2):
        na, nb, nc = a.draw(shape), b.draw(shape), c.draw(shape)
        assert len(na) == 2 and tuple(na[0].shape) == (2, 32, 2)
        assert all(torch.equal(x, y) for x, y in zip(na, nb))
        assert not torch.equal(na[0], nc[0])
        assert not torch.equal(na[0], na[1])
    assert not torch.equal(na[0], td.MaskNoise(model, 3).draw(shape)[0])
    assert td.MaskNoise(td.build_detector(presets.get_config("tiny"),
                                          device="cpu")).draw(shape) is None


# ---------------------------------------------------------------------------
# the bench's sweep
# ---------------------------------------------------------------------------

def _jax_bench():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "jax_bench", Path(__file__).resolve().parents[1] / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_families_are_the_jax_bench_families():
    from toc3d_tpu_torch import bench
    jb = _jax_bench()
    assert bench.SWEEP_FAMILIES == jb.SWEEP_FAMILIES
    assert bench.A100_PIPELINE_MS == jb.A100_PIPELINE_MS
    for _, names in bench.SWEEP_FAMILIES:
        for name in names:
            assert name in presets.PRESETS


def test_sweep_parses_runs_and_prints_its_table():
    """parse_run reads a run's wall ms/frame, peak memory and JSON line;
    the table gives each config's speedup over its family's baseline and
    the paper's A100 figure beside it, and marks a failed run."""
    from toc3d_tpu_torch import bench
    out = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
           "peak device memory 2.476 GiB (warm-up and capture included)\n"
           "wall 40.000 ms/frame\n"
           "  inputs         device ms/frame mean 0.5\n"
           '{"metric": "x", "value": 25.0, "unit": "frames/s", '
           '"vs_baseline": 28.0}\n')
    rec = bench.parse_run(out)
    assert rec == {"fps": 25.0, "metric": "x", "ms": 40.0, "peak_gib": 2.476}
    assert bench.parse_run("Traceback ...\n") is None
    results = {name: dict(rec, ms=60.0 - 10.0 * i, fps=1000 / (60 - 10 * i))
               for _, names in bench.SWEEP_FAMILIES
               for i, name in enumerate(names)}
    results["ToC3D_vit_b_faster"] = None
    table = bench.sweep_table(results).splitlines()
    assert len(table) == 2 + 9
    row = next(r for r in table if "| ToC3D_faster_1600 |" in r)
    assert "| 40.0 |" in row and "1.5000x" in row and "| 2.476 |" in row
    assert "878.5 (1.491x)" in row
    assert "1 (baseline)" in next(r for r in table
                                 if "| stream_petr_vit_b |" in r)
    assert "FAILED" in next(r for r in table if "ToC3D_vit_b_faster" in r)


def test_plain_backbone_int8_dynamic_runs_and_static_raises_as_jax():
    """int8 serving of the plain backbone: dynamic scales run (B8's plain
    version here); static calibration raises NotImplementedError in both
    packages, whose collected forward covers the ToC3D backbone only."""
    from dataclasses import replace as rep
    from toc3d_tpu.ops.int8_calib import backbone_site_amax
    from toc3d_tpu_torch.ops.int8_calib import calibrate_act_scales
    jcfg, tcfg = _tiny(JaxEVAViTConfig(**_TINY_VIT),
                       EVAViTConfig(**_TINY_VIT))
    rng = np.random.RandomState(29)
    sd = _reference_dict(jcfg, rng)
    frame = make_frames(rng, jcfg, t_total=1)[0]
    params = convert_detector_checkpoint(sd, jcfg)
    with pytest.raises(NotImplementedError, match="ToC3D backbone"):
        backbone_site_amax(params, jcfg, {k: jnp.asarray(v)
                                          for k, v in frame.items()},
                           jax_init_state(1, jcfg).memory)
    qcfg = rep(tcfg, backbone=rep(tcfg.backbone, quant="int8"))
    model = td.build_detector(qcfg, device="cpu", state_dict=sd)
    tf = td.frame_to_device(frame, "cpu")
    with pytest.raises(NotImplementedError, match="ToC3D backbone"):
        calibrate_act_scales(model, [tf])
    state, det = td.make_infer_fn(model)(td.init_state(1, qcfg, "cpu"), tf)
    assert torch.isfinite(det.scores).all()
    assert torch.isfinite(state.memory.embedding).all()
