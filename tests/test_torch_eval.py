"""The port's streaming eval (toc3d_tpu_torch/data, runtime/eval.py,
runtime/nusc_metrics.py, tools/test.py) against the JAX package's, on the
CPU, on the same seeded inputs:

* the synthetic scenes, the infos reader, the eval sampler and the eval
  frames: bit for bit, the frames in three modes (exact, fast decode, fast
  decode with the device normalize) at a 90x160 -> 64x128 resize, a
  90x160 -> 70x120 resize padded to 96x128, and 1600x900 -> AUG_1600x800
  (six views, the identity resize and a crop);
* the submission writer: the same JSON bytes for the same boxes;
* the detection metrics: equal dicts on the 50 seeds of
  tests/test_metrics_agreement.py and the fixtures of
  tests/test_nusc_metrics_fixtures.py; perfect predictions score mAP 1;
* a 2-scene `tiny` stream through JAX's loop and the port's
  ``streaming_eval``, weights carried by convert.params_from_jax: the same
  tokens, per-sample counts, names and attributes, floats within 1e-3
  (tests/test_parity_detector.py's limit), near-tied scores (within 1e-6)
  in either order, as tests/test_torch_presets.py allows;
* the eval CLI (``python -m toc3d_tpu_torch.tools.test --device cpu``) on
  a synthetic pkl, its checkpoint loading and its refusals.
"""
import json
import math
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.data import loader as jloader
from toc3d_tpu.data import nuscenes as jnus
from toc3d_tpu.data import sampler as jsampler
from toc3d_tpu.data import synthetic as jsynth
from toc3d_tpu.models.detector import init_detector as jax_init_detector
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.models.detector import make_infer_fn as jax_make_infer_fn
from toc3d_tpu.runtime import eval as jeval
from toc3d_tpu.runtime import nusc_metrics as jmetrics

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.convert import (load_reference_checkpoint,
                                     params_from_jax)
from toc3d_tpu_torch.data import loader as tloader
from toc3d_tpu_torch.data import nuscenes as tnus
from toc3d_tpu_torch.data import sampler as tsampler
from toc3d_tpu_torch.data import synthetic as tsynth
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.runtime import eval as teval
from toc3d_tpu_torch.runtime import nusc_metrics as tmetrics
from toc3d_tpu_torch.tools import test as eval_cli

from test_data_pipeline import TINY_AUG
from test_metrics_agreement import random_scenario
from test_nusc_metrics_fixtures import box

ROOT = Path(__file__).resolve().parents[1]
TINY_SRC = dict(src_h=90, src_w=160)


@pytest.fixture(scope="module")
def tiny_pkl(tmp_path_factory):
    """The port's learnable synthetic scenes: 2 scenes x 3 frames, 2 views
    of 90x160."""
    return tsynth.make_learnable_dataset(
        str(tmp_path_factory.mktemp("tiny")), n_scenes=2,
        frames_per_scene=3, n_cams=2, seed=3, **TINY_SRC)


@pytest.fixture(scope="module")
def full_pkl(tmp_path_factory):
    """One frame of six 1600x900 views."""
    return tsynth.make_learnable_dataset(
        str(tmp_path_factory.mktemp("full")), n_scenes=1,
        frames_per_scene=1, n_cams=6, src_h=900, src_w=1600, seed=5)


def _same(a, b, path="x"):
    """Nested equality: dicts by keys, sequences item by item, arrays by
    dtype, shape and value (NaN equal to NaN), floats exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_synthetic_scenes_equal_jax(tmp_path):
    """make_learnable_dataset writes the same infos and the same JPEG bytes
    as JAX's (paths aside: each writes under its own directory)."""
    kw = dict(n_scenes=2, frames_per_scene=2, n_cams=2, seed=1, drift=0.5,
              **TINY_SRC)
    paths = [mod.make_learnable_dataset(str(tmp_path / name), **kw)
             for name, mod in (("jax", jsynth), ("port", tsynth))]
    infos = []
    for p in paths:
        with open(p, "rb") as f:
            data = pickle.load(f)
        for info in data["infos"]:
            for cam in info["cams"].values():
                with open(cam["data_path"], "rb") as f:
                    cam["data_path"] = f.read()
        infos.append(data)
    _same(infos[0], infos[1])


def test_infos_reader_and_sampler_equal_jax(tiny_pkl):
    """NuScenesInfos (order, scene groups and their splits, t0, frame_meta,
    annotations, prev_exists), the eval augmentation and
    contiguous_eval_chunks equal JAX's."""
    for split in (1, 2, "all"):
        j = jnus.NuScenesInfos(tiny_pkl, seq_split_num=split)
        t = tnus.NuScenesInfos(tiny_pkl, seq_split_num=split)
        _same(t.flag, j.flag)
        assert (t.t0, t.version, len(t)) == (j.t0, j.version, len(j))
        for i in range(len(j)):
            _same(t.frame_meta(i), j.frame_meta(i))
            _same(t.annotations(i), j.annotations(i))
            assert t.prev_exists(i) == j.prev_exists(i)
    for aug in ("AUG_800x320", "AUG_1600x800"):
        r = tnus.sample_augmentation(getattr(tnus, aug), training=False)
        _same(r, jnus.sample_augmentation(getattr(jnus, aug),
                                          training=False))
        _same(tnus.ida_matrix(r[0], r[2], r[3]),
              jnus.ida_matrix(r[0], r[2], r[3]))
    for n in (0, 1, 7, 12, 13):
        for reps in (1, 2, 3, 5):
            for rank in range(reps):
                assert (tsampler.contiguous_eval_chunks(n, reps, rank)
                        == jsampler.contiguous_eval_chunks(n, reps, rank))


MODES = {"exact": {}, "fast_decode": {"fast_decode": True},
         "fast_decode+device_normalize": {"fast_decode": True,
                                          "device_normalize": True}}


@pytest.mark.parametrize("size", ["tiny", "padded", "1600x900"])
@pytest.mark.parametrize("mode", list(MODES))
def test_eval_frame_bit_equal_jax(request, size, mode):
    """build_eval_frame: every array of the frame and the formatting meta,
    bit for bit. At 1600x900 -> AUG_1600x800 the resize is the identity and
    the frame a crop; at 90x160 -> 64x128 a real resample; at 90x160 ->
    70x120 a resample and a pad to 96x128 (the mean pixel in uint8)."""
    if size in ("tiny", "padded"):
        pkl, jaug = request.getfixturevalue("tiny_pkl"), TINY_AUG
        if size == "padded":
            jaug = jnus.AugConfig(final_dim=(70, 120), H=90, W=160)
        taug = tnus.AugConfig(**{k: getattr(jaug, k) for k in (
            "resize_lim", "final_dim", "bot_pct_lim", "H", "W",
            "rand_flip")})
        idx = (0, 4)
    else:
        pkl, jaug, taug = (request.getfixturevalue("full_pkl"),
                           jnus.AUG_1600x800, tnus.AUG_1600x800)
        idx = (0,)
        r = tnus.sample_augmentation(taug, training=False)
        assert r == (1.0, (1600, 900), (0, 100, 1600, 900), False)
    jinfos, tinfos = jnus.NuScenesInfos(pkl), tnus.NuScenesInfos(pkl)
    for i in idx:
        jf, jm = jloader.build_eval_frame(jinfos, i, jaug, **MODES[mode])
        tf, tm = tloader.build_eval_frame(tinfos, i, taug, **MODES[mode])
        _same(tf, jf)
        _same(tm, jm)
        want = np.uint8 if "device_normalize" in mode else np.float32
        assert tf["img"].dtype == want
        assert tf["img"].shape[2:4] == tuple(
            -(-d // 32) * 32 for d in taug.final_dim)


def test_eval_frame_refuses_device_normalize_without_fast_decode(tiny_pkl):
    infos = tnus.NuScenesInfos(tiny_pkl)
    with pytest.raises(ValueError, match="fast_decode"):
        tloader.build_eval_frame(infos, 0, TINY_AUG, device_normalize=True)


def test_prefetch_iterator_keeps_order_and_raises():
    assert list(tloader.PrefetchIterator(iter(range(20)), depth=2)) == \
        list(range(20))

    def broken():
        yield 1
        raise KeyError("bad sample")
    it = tloader.PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad sample"):
        next(it)


def _random_detections(seed, n=40):
    """Boxes in every class, some beyond their class range, slow and fast
    (both sides of the 0.2 m/s attribute rule), and a pose per sample."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(-70, 70, (n, 2)), rng.uniform(-3, 1, (n, 1)),
        rng.uniform(0.3, 8, (n, 3)), rng.uniform(-4, 4, (n, 1)),
        rng.uniform(-0.3, 0.3, (n, 2)) * rng.choice([1, 30], (n, 1))],
        axis=1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(0, 10, n)

    def quat():
        q = rng.randn(4)
        return (q / np.linalg.norm(q)).tolist()
    meta = {"token": f"tok{seed}", "scene_token": "scene",
            "lidar2ego_rotation": quat(),
            "lidar2ego_translation": rng.randn(3).tolist(),
            "ego2global_rotation": quat(),
            "ego2global_translation": (rng.randn(3) * 100).tolist()}
    return boxes, scores, labels, meta


def test_submission_json_bytes_equal_jax(tmp_path):
    """detections_to_nusc_annos + write_submission on identical boxes give
    identical results_nusc.json bytes."""
    files = []
    for name, mod in (("jax", jeval), ("port", teval)):
        results = {}
        for seed in range(4):
            boxes, scores, labels, meta = _random_detections(seed)
            results[meta["token"]] = mod.detections_to_nusc_annos(
                boxes, scores, labels, meta)
        assert sum(map(len, results.values())) > 0
        with open(mod.write_submission(results, str(tmp_path / name)),
                  "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]


def _fixture_cases():
    """(gt, pred, class_names) of each fixture of
    tests/test_nusc_metrics_fixtures.py."""
    ego = [0.0, 0.0, 0.0]
    yaw = math.pi - 0.1
    return {
        "near_threshold": ({"s0": [box(0, 0)]},
                           {"s0": [box(0, 1.5, score=0.9)]}, ("car",)),
        "duplicate": ({"s0": [box(0, 0), box(20, 0), box(40, 0)]},
                      {"s0": [box(0, 0.1, score=0.9),
                              box(0, 0.2, score=0.85),
                              box(20, 0.1, score=0.8),
                              box(40, 0.1, score=0.7)]}, ("car",)),
        "attr_cummean": (
            {"s0": [box(0, 0, attr="vehicle.moving"),
                    box(20, 0, attr="vehicle.moving")]},
            {"s0": [box(0, 0, score=0.9, attr="vehicle.parked"),
                    box(20, 0, score=0.5, attr="vehicle.moving")]},
            ("car",)),
        "scale_velocity": ({"s0": [box(0, 0, vel=(0, 0))]},
                           {"s0": [box(0, 0, score=0.9, size=(2, 2, 2),
                                       vel=(3, 4))]}, ("car",)),
        "barrier_period": (
            {"s0": [box(0, 0, "barrier"), box(9, 0, "car")]},
            {"s0": [box(0, 0, "barrier", score=0.9, yaw=yaw),
                    box(9, 0, "car", score=0.8, yaw=yaw)]},
            ("barrier", "car")),
        "class_range": ({"s0": [box(45, 0, ego=ego), box(55, 0, ego=ego)]},
                        {"s0": [box(45, 0.1, score=0.9, ego=ego),
                                box(55, 0.1, score=0.8, ego=ego)]},
                        ("car",)),
        "exclusions_nds": (
            {"s0": [box(0, 0, "barrier"), box(20, 0, "traffic_cone")]},
            {"s0": [box(0, 0.3, "barrier", score=0.9),
                    box(20, 0.3, "traffic_cone", score=0.8)]},
            ("barrier", "traffic_cone")),
        "low_recall": ({"s0": [box(i * 5, 0) for i in range(11)]},
                       {"s0": [box(0, 0.2, score=0.9)]}, ("car",)),
    }


METRIC_CASES = [f"seed{s}" for s in range(50)] + list(_fixture_cases())


@pytest.mark.parametrize("case", METRIC_CASES)
def test_detection_metrics_equal_jax(case):
    """nusc_metrics.evaluate gives JAX's dict exactly: mAP, NDS, every
    class's AP at every distance and the TP errors."""
    if case.startswith("seed"):
        gt, pred = random_scenario(int(case[4:]))
        names = tuple(jmetrics.CLASS_RANGE)
    else:
        gt, pred, names = _fixture_cases()[case]
    _same(tmetrics.evaluate(gt, pred, class_names=names),
          jmetrics.evaluate(gt, pred, class_names=names))


def test_perfect_predictions_score_map_one(tmp_path):
    """The port's twin of tests/test_eval_geometry_closure.py: the GT boxes
    of a converted info pkl, formatted through detections_to_nusc_annos,
    meet build_gt_from_infos exactly: mAP 1, NDS 1."""
    from toc3d_tpu.data.convert import create_nuscenes_infos
    from test_convert import make_raw_tables
    (path,) = create_nuscenes_infos(make_raw_tables(str(tmp_path)),
                                    "v1.0-synth", str(tmp_path))
    infos = tnus.NuScenesInfos(path)
    gt = tmetrics.build_gt_from_infos(infos.infos)
    results = {}
    for i, info in enumerate(infos.infos):
        ann = infos.annotations(i)
        keep = ann["gt_labels_3d"] >= 0
        annos = teval.detections_to_nusc_annos(
            ann["gt_bboxes_3d"][keep], np.ones(keep.sum()),
            ann["gt_labels_3d"][keep], info)
        for pred in annos:      # the GT's attribute, as the JAX test does
            pred["attribute_name"] = next(
                g["attribute_name"] for g in gt[info["token"]]
                if np.allclose(pred["translation"], g["translation"],
                               atol=1e-3))
        results[info["token"]] = annos
    present = sorted({a["detection_name"] for annos in gt.values()
                      for a in annos})
    m = tmetrics.evaluate(gt, results, class_names=present)
    assert abs(m["mAP"] - 1.0) < 1e-6, m
    assert abs(m["NDS"] - 1.0) < 1e-3, m
    assert m["tp_errors"]["trans_err"] < 1e-3, m["tp_errors"]


def _tiny_configs():
    jcfg = jax_get_config("tiny")
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone, mxu_align_k=True))
    tcfg = get_config("tiny")
    tcfg = replace(tcfg, backbone=replace(tcfg.backbone, mxu_align_k=True))
    return jcfg, tcfg


def _same_annos(tok, t, j):
    """One sample's annotations: the same count; each of the port's with
    the JAX one at its rank, or, where scores lie within 1e-6 of the
    port's (a near tie that a last bit orders either way), one of those:
    names and attributes equal, every float within 1e-3."""
    assert len(t) == len(j), tok
    js = np.array([a["detection_score"] for a in j])
    for i, a in enumerate(t):
        tied = np.flatnonzero(np.abs(js - a["detection_score"]) <= 1e-6)
        cands = sorted(set(tied) | {i}, key=lambda k: abs(k - i))
        assert any(
            j[k]["detection_name"] == a["detection_name"]
            and j[k]["attribute_name"] == a["attribute_name"]
            and j[k]["sample_token"] == a["sample_token"]
            and abs(j[k]["detection_score"] - a["detection_score"]) <= 1e-3
            and all(np.allclose(a[f], j[k][f], atol=1e-3, rtol=0)
                    for f in ("translation", "size", "rotation",
                              "velocity"))
            for k in cands), f"{tok} box {i}: {a} against {j[i]}"


def test_tiny_streaming_eval_matches_jax(tiny_pkl):
    """Two scenes of three frames through JAX's streaming_eval (its
    make_infer_fn) and the port's (make_infer_fn on the CPU), the same
    random weights (JAX's init_detector, carried by params_from_jax), the
    same frames: the memory resets at the second scene on both sides."""
    jcfg, tcfg = _tiny_configs()
    params = jax.jit(lambda k: jax_init_detector(k, jcfg))(
        jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), jcfg)
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    aug = eval_cli.eval_aug(tcfg, **TINY_SRC)
    infos = tnus.NuScenesInfos(tiny_pkl)
    pairs = [tloader.build_eval_frame(infos, i, aug)
             for i in range(len(infos))]
    frames, metas = [p[0] for p in pairs], [p[1] for p in pairs]
    assert [m["scene_token"] for m in metas] == ["scene0"] * 3 + \
        ["scene1"] * 3
    jres = jeval.streaming_eval(jax_make_infer_fn(jcfg), params,
                                lambda: jax_init_state(1, jcfg), frames,
                                metas)
    tres = teval.streaming_eval(td.make_infer_fn(model),
                                lambda: td.init_state(1, tcfg, "cpu"),
                                frames, metas)
    assert list(tres) == list(jres) == [m["token"] for m in metas]
    assert sum(map(len, tres.values())) > 0
    for tok in jres:
        _same_annos(tok, tres[tok], jres[tok])


def test_eval_cli_writes_a_submission_nusc_metrics_scores(tiny_pkl,
                                                          tmp_path):
    """python -m toc3d_tpu_torch.tools.test --device cpu --config tiny on
    the synthetic pkl: every sample in the submission, mAP and NDS from
    the internal evaluator finite and in [0, 1]."""
    work = tmp_path / "eval"
    r = subprocess.run(
        [sys.executable, "-m", "toc3d_tpu_torch.tools.test", "--device",
         "cpu", "--config", "tiny", "--ann", tiny_pkl, "--work-dir",
         str(work), "--src-h", "90", "--src-w", "160"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(work / "results_nusc.json") as f:
        sub = json.load(f)
    infos = tnus.NuScenesInfos(tiny_pkl)
    assert set(sub["results"]) == {i["token"] for i in infos.infos}
    assert sub["meta"]["use_camera"] is True
    m = tmetrics.evaluate(tmetrics.build_gt_from_infos(infos.infos),
                          sub["results"])
    assert 0.0 <= m["mAP"] <= 1.0 and 0.0 <= m["NDS"] <= 1.0
    printed = json.loads(r.stdout.strip().splitlines()[-1])
    assert printed == {"mAP": m["mAP"], "NDS": m["NDS"],
                       "evaluator": "internal"}


def test_eval_cli_loads_a_reference_checkpoint(tiny_pkl, tmp_path):
    """--checkpoint x.pth: a reference file (state_dict entry, legacy head
    names, non-tensor meta) loads into the detector strictly, and the eval
    equals streaming_eval on the same weights; an orbax directory
    raises."""
    from test_full_converter import build_reference_state_dict
    jcfg, tcfg = _tiny_configs()
    sd = build_reference_state_dict(jcfg, np.random.RandomState(2))
    legacy = {k.replace(".attentions.0.", ".self_attn.")
              .replace(".decoder.post_norm.", ".decoder.norm."):
              torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    assert legacy.keys() != sd.keys()
    pth = tmp_path / "ckpt.pth"
    torch.save({"state_dict": legacy, "meta": {"epoch": 24}}, pth)
    loaded = load_reference_checkpoint(str(pth))
    assert set(loaded) == set(sd)
    out = eval_cli.main(["--device", "cpu", "--config", "tiny", "--ann",
                         tiny_pkl, "--checkpoint", str(pth), "--work-dir",
                         str(tmp_path / "eval"), "--src-h", "90",
                         "--src-w", "160", "--limit", "4"])
    model = td.build_detector(get_config("tiny"), device="cpu",
                              state_dict=sd)
    infos = tnus.NuScenesInfos(tiny_pkl)
    aug = eval_cli.eval_aug(model.cfg, **TINY_SRC)
    pairs = [tloader.build_eval_frame(infos, i, aug) for i in range(4)]
    ref = teval.streaming_eval(td.make_infer_fn(model),
                               lambda: td.init_state(1, model.cfg, "cpu"),
                               [p[0] for p in pairs], [p[1] for p in pairs])
    assert json.dumps(out["results"]) == json.dumps(ref)
    with pytest.raises(ValueError, match="orbax"):
        eval_cli.main(["--device", "cpu", "--config", "tiny", "--ann",
                       tiny_pkl, "--checkpoint", str(tmp_path)])


def test_eval_cli_defaults_to_cuda_and_refuses(tiny_pkl, monkeypatch):
    """The default device is cuda; without a card it raises, and so does
    --distributed without a rendezvous (no torchrun environment, no
    --dist-coordinator), on the card's default device and on the CPU."""
    from toc3d_tpu_torch.tools import track as track_cli
    assert eval_cli.parse_args(["--config", "tiny", "--ann", "x"]).device \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--config", "tiny", "--ann", tiny_pkl])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track_cli.main(["--results", "r.json", "--ann", tiny_pkl])
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--config", "tiny", "--ann", tiny_pkl,
                       "--distributed"])
    with pytest.raises(RuntimeError, match="no rendezvous"):
        eval_cli.main(["--config", "tiny", "--ann", tiny_pkl, "--device",
                       "cpu", "--distributed"])
