"""The port's tracking (toc3d_tpu_torch/tracking, tools/track.py) and its
token visualizer against the JAX package's, on the CPU, on the same
inputs:

* the tracker, greedy and Hungarian, with strict_parity both ways, on a
  detection submission with moving objects, clutter, non-tracking classes
  and empty frames: identical tracking results;
* evaluate_tracking: identical results on the 50 scenarios of
  tests/test_metrics_agreement.py and on the tracker's own output against
  the tracking GT of synthetic infos;
* the tracking CLI (--device cpu) against JAX's track_detections;
* infer_step_with_aux: the selectors' token masks of a `tiny` stream
  against JAX's (1e-5), and the visualizer's PNGs byte for byte.
"""
import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.tracking import metrics as jmetrics
from toc3d_tpu.tracking import pub_tracker as jtracker
from toc3d_tpu.runtime import token_vis as jvis

from toc3d_tpu_torch.data import synthetic as tsynth
from toc3d_tpu_torch.data.nuscenes import NuScenesInfos
from toc3d_tpu_torch.tracking import metrics as tmetrics
from toc3d_tpu_torch.tracking import pub_tracker as ttracker
from toc3d_tpu_torch.runtime import token_vis as tvis

from test_metrics_agreement import random_tracking_scenario
from test_torch_eval import _same

NAMES = ("car", "pedestrian", "bus", "truck", "barrier", "bicycle")


def _submission(seed=0, n_scenes=2, n_frames=6):
    """A detection submission and its frames (frames_from_infos' form):
    objects moving at their velocity (up to 6 m/s: an object can move
    farther in a frame than the 2.5 m match gate, so only the velocity
    backcast matches it) with noisy detections, packed so that gates
    overlap,
    clutter, a non-tracking class, scores on both sides of the threshold
    and one empty frame a scene."""
    rng = np.random.RandomState(seed)
    preds, frames, t = {}, [], 0.0
    for s in range(n_scenes):
        objs = [(NAMES[rng.randint(len(NAMES))], rng.uniform(-15, 15, 2),
                 rng.uniform(-6, 6, 2)) for _ in range(10)]
        for f in range(n_frames):
            tok = f"s{s}f{f}"
            frames.append({"token": tok, "timestamp": t, "first": f == 0})
            annos = []
            if f != 3:
                for name, p0, v in objs:
                    if rng.rand() < 0.2:
                        continue
                    p = p0 + v * 0.5 * f + rng.randn(2) * 0.3
                    annos.append(_det(tok, name, p, v, rng.uniform(0.1, 1)))
                for _ in range(rng.randint(0, 3)):
                    annos.append(_det(tok, NAMES[rng.randint(len(NAMES))],
                                      rng.uniform(-40, 40, 2),
                                      rng.randn(2), rng.uniform(0, 0.5)))
            preds[tok] = annos
            t += 0.5
    return preds, frames


def _det(tok, name, p, v, score):
    return {"sample_token": tok, "translation": [float(p[0]), float(p[1]),
                                                 1.0],
            "size": [2.0, 4.0, 1.5], "rotation": [1.0, 0.0, 0.0, 0.0],
            "velocity": [float(v[0]), float(v[1])], "detection_name": name,
            "detection_score": float(score), "attribute_name": ""}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("hungarian", [False, True])
def test_tracker_matches_jax(hungarian, strict):
    preds, frames = _submission()
    kw = dict(max_age=3, score_threshold=0.25, hungarian=hungarian,
              strict_parity=strict)
    t = ttracker.track_detections(preds, frames, **kw)
    j = jtracker.track_detections(preds, frames, **kw)
    assert sum(map(len, t["results"].values())) > 0
    _same(t["results"], j["results"])
    _same(t["meta"], j["meta"])


@pytest.mark.parametrize("seed", range(50))
def test_tracking_metrics_match_jax(seed):
    gt, pred, scenes = random_tracking_scenario(seed)
    _same(tmetrics.evaluate_tracking(gt, pred, scenes),
          jmetrics.evaluate_tracking(gt, pred, scenes))


@pytest.fixture(scope="module")
def infos_pkl(tmp_path_factory):
    return tsynth.make_learnable_dataset(
        str(tmp_path_factory.mktemp("trk")), n_scenes=2, frames_per_scene=4,
        n_cams=1, src_h=45, src_w=80, seed=2, drift=1.0)


def test_tracking_of_synthetic_infos_matches_jax(infos_pkl):
    """The GT's boxes as detections (with noise), tracked and scored
    against build_tracking_gt_from_infos: frames, GT, scenes and metrics
    identical to JAX's."""
    infos = NuScenesInfos(infos_pkl).infos
    frames = ttracker.frames_from_infos(infos)
    _same(frames, jtracker.frames_from_infos(infos))
    gt = tmetrics.build_tracking_gt_from_infos(infos)
    _same(gt, jmetrics.build_tracking_gt_from_infos(infos))
    scenes = tmetrics.scenes_from_infos(infos)
    _same(scenes, jmetrics.scenes_from_infos(infos))
    rng = np.random.RandomState(4)
    preds = {tok: [dict(_det(tok, b["tracking_name"],
                             np.asarray(b["translation"][:2])
                             + rng.randn(2) * 0.2, b["velocity"],
                             rng.uniform(0.3, 1)))
                   for b in boxes] for tok, boxes in gt.items()}
    res = ttracker.track_detections(preds, frames)["results"]
    _same(tmetrics.evaluate_tracking(gt, res, scenes),
          jmetrics.evaluate_tracking(gt, res, scenes))
    assert tmetrics.evaluate_tracking(gt, res, scenes)["AMOTA"] > 0


def test_track_cli_matches_jax(infos_pkl, tmp_path):
    """python -m toc3d_tpu_torch.tools.track --device cpu --eval on a
    submission: tracking_result.json holds JAX's track_detections results,
    and the metrics are JAX's."""
    from toc3d_tpu_torch.tools import track as track_cli
    infos = NuScenesInfos(infos_pkl).infos
    preds, _ = _submission(seed=1, n_scenes=1, n_frames=len(infos))
    preds = {i["token"]: [dict(a, sample_token=i["token"])
                          for a in preds[f"s0f{k}"]]
             for k, i in enumerate(infos)}
    path = tmp_path / "results_nusc.json"
    path.write_text(json.dumps({"results": preds}))
    out = track_cli.main(["--results", str(path), "--ann", infos_pkl,
                          "--work-dir", str(tmp_path / "trk"), "--hungarian",
                          "--eval", "--device", "cpu"])
    with open(out["path"]) as f:
        written = json.load(f)
    ref = jtracker.track_detections(preds, jtracker.frames_from_infos(
        infos), max_age=3, score_threshold=0.25, hungarian=True)
    _same(written["results"], json.loads(json.dumps(ref["results"])))
    gt = jmetrics.build_tracking_gt_from_infos(infos)
    _same(out["metrics"], jmetrics.evaluate_tracking(
        gt, ref["results"], jmetrics.scenes_from_infos(infos)))


def test_infer_step_with_aux_masks_match_jax(tmp_path):
    """The selectors' token masks of a 3-frame `tiny` stream (prev_exists
    0, 1, 1) from the port's infer_step_with_aux against JAX's at 1e-5,
    its boxes against infer_step's, and token_selection_vis writes the
    same PNG bytes for the same image and masks."""
    from toc3d_tpu.configs import get_config as jax_get_config
    from toc3d_tpu.models.detector import infer_step_with_aux as jax_aux
    from toc3d_tpu.models.detector import init_state as jax_init_state
    from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models import detector as td
    from test_full_converter import build_reference_state_dict
    from test_parity_detector import make_frames

    jcfg = jax_get_config("tiny")
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone, mxu_align_k=True))
    tcfg = get_config("tiny")
    tcfg = replace(tcfg, backbone=replace(tcfg.backbone, mxu_align_k=True))
    rng = np.random.RandomState(5)
    sd = build_reference_state_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    step = jax.jit(lambda p, s, f: jax_aux(p, jcfg, s, f))
    jstate = jax_init_state(1, jcfg)
    tstate = td.init_state(1, tcfg, device="cpu")
    for t, frame in enumerate(make_frames(rng, jcfg, t_total=3)):
        jstate, _, jaux = step(params, jstate,
                               {k: jnp.asarray(v) for k, v in frame.items()})
        plain_state, plain = td.infer_step(model, tstate, frame)
        tstate, tdet, taux = td.infer_step_with_aux(model, tstate, frame)
        assert len(taux["token_masks"]) == len(jaux["token_masks"]) == 1
        for tm, jm in zip(taux["token_masks"], jaux["token_masks"]):
            assert tuple(tm.shape) == jm.shape
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                       atol=1e-5, err_msg=f"frame {t}")
        for a, b in zip(tuple(tdet) + tuple(tstate.memory),
                        tuple(plain) + tuple(plain_state.memory)):
            assert bool((a == b).all()), f"frame {t}"
    masks = [tm.numpy() for tm in taux["token_masks"]]
    img = frame["img"][0]
    tvis.token_selection_vis(img, masks, str(tmp_path / "port"))
    jvis.token_selection_vis(img, masks, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
