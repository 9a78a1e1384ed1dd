"""The port's training data path and trainer CLI on the CPU: the train
augmentations (transform_boxes2d, filter_invisible, global_rot_scale_trans),
build_train_sample / build_train_sequence, the GT padding, collate_batch and
the batch-lane sampler against the JAX package's (toc3d_tpu/data/), equal
array for array given one numpy RandomState seed, on learnable synthetic
scenes (data/synthetic.py); then ``python -m toc3d_tpu_torch.tools.train
--device cpu --config tiny`` for 2 iterations: finite losses logged, a
checkpoint written, a resume from it, and the eval through the eval CLI.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from toc3d_tpu.data import loader as jloader
from toc3d_tpu.data import nuscenes as jnus
from toc3d_tpu.data import sampler as jsampler

from toc3d_tpu_torch.data import loader as tloader
from toc3d_tpu_torch.data import nuscenes as tnus
from toc3d_tpu_torch.data import sampler as tsampler
from toc3d_tpu_torch.data.synthetic import make_learnable_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_train")
    return make_learnable_dataset(str(d), n_scenes=2, frames_per_scene=4,
                                  src_h=90, src_w=160)


def _aug():
    kw = dict(final_dim=(64, 128), H=90, W=160,
              resize_lim=(64 / 90 * 0.95, 64 / 90 * 1.2))
    return jnus.AugConfig(**kw), tnus.AugConfig(**kw)


def test_box_augmentations_match_jax():
    rng = np.random.RandomState(0)
    for trial in range(5):
        n = 12
        xy = np.sort(rng.rand(n, 2, 2) * 200, axis=1).reshape(n, 4)
        boxes = xy.astype(np.float32)
        centers = ((boxes[:, :2] + boxes[:, 2:]) / 2).astype(np.float32)
        labels = rng.randint(0, 10, n)
        depths = (rng.rand(n) * 50).astype(np.float32)
        args = (0.6, (10, 5, 138, 69), bool(trial % 2), (64, 128))
        got = tnus.transform_boxes2d(boxes.copy(), centers.copy(), labels,
                                     depths, *args)
        want = jnus.transform_boxes2d(boxes.copy(), centers.copy(), labels,
                                      depths, *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if len(got[0]):
            for g, w in zip(tnus.filter_invisible(*got, (64, 128)),
                            jnus.filter_invisible(*want, (64, 128))):
                np.testing.assert_array_equal(g, w)
        meta = {"lidar2img": [rng.randn(4, 4) for _ in range(2)],
                "ego_pose": rng.randn(4, 4), "ego_pose_inv": rng.randn(4, 4)}
        b3 = rng.randn(5, 9).astype(np.float32)
        m1, g1 = tnus.global_rot_scale_trans(
            {k: (list(v) if isinstance(v, list) else v.copy())
             for k, v in meta.items()}, b3, np.random.RandomState(trial))
        m2, g2 = jnus.global_rot_scale_trans(
            {k: (list(v) if isinstance(v, list) else v.copy())
             for k, v in meta.items()}, b3, np.random.RandomState(trial))
        np.testing.assert_array_equal(g1, g2)
        for k in m1:
            np.testing.assert_array_equal(np.asarray(m1[k]),
                                          np.asarray(m2[k]))


def test_build_train_sample_and_collate_match_jax(synth):
    ja, ta = _aug()
    jinfos, tinfos = jnus.NuScenesInfos(synth), tnus.NuScenesInfos(synth)
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    js = [jloader.build_train_sample(jinfos, i, ja, rj, max_gt_3d=4)
          for i in (0, 5)]
    ts = [tloader.build_train_sample(tinfos, i, ta, rt, max_gt_3d=4)
          for i in (0, 5)]
    for a, b in zip(ts, js):
        _equal_dicts(a, b)
    _equal_dicts(tsampler.collate_batch(ts), jsampler.collate_batch(js))
    assert ts[0]["gt_valid_3d"].any()
    seq_t = tloader.build_train_sequence(tinfos, 5, 3, ta,
                                         np.random.RandomState(4),
                                         max_gt_3d=4)
    seq_j = jloader.build_train_sequence(jinfos, 5, 3, ja,
                                         np.random.RandomState(4),
                                         max_gt_3d=4)
    _equal_dicts(seq_t, seq_j)


def test_pad_gt_and_sampler_match_jax():
    rng = np.random.RandomState(5)
    boxes = rng.randn(7, 9).astype(np.float32)
    labels = rng.randint(0, 10, 7)
    for g in (4, 10):
        for a, b in zip(tsampler.pad_gt_3d(boxes, labels, g),
                        jsampler.pad_gt_3d(boxes, labels, g)):
            np.testing.assert_array_equal(a, b)
    per_view = [rng.rand(k, 4).astype(np.float32) for k in (0, 3, 6)]
    lab = [rng.randint(0, 10, len(b)) for b in per_view]
    ctr = [rng.rand(len(b), 2).astype(np.float32) for b in per_view]
    for a, b in zip(tsampler.pad_gt_2d(per_view, lab, ctr, 4),
                    jsampler.pad_gt_2d(per_view, lab, ctr, 4)):
        np.testing.assert_array_equal(a, b)
    flags = np.repeat(np.arange(5), [3, 4, 2, 5, 3])
    for bs, reps, rank in ((2, 1, 0), (1, 2, 1)):
        t = iter(tsampler.InfiniteGroupEachSampleInBatchSampler(
            flags, bs, reps, rank, seed=7))
        j = iter(jsampler.InfiniteGroupEachSampleInBatchSampler(
            flags, bs, reps, rank, seed=7))
        assert [next(t) for _ in range(20)] == [next(j) for _ in range(20)]
    assert tsampler.contiguous_eval_chunks(10, 3, 2) == \
        jsampler.contiguous_eval_chunks(10, 3, 2)


def test_train_cli_two_iterations_checkpoint_and_resume(synth, tmp_path):
    """The trainer CLI on the CPU: 2 iterations, finite losses in
    train.log.json, a checkpoint, then a resumed third iteration and the
    eval through the eval CLI's path."""
    work = tmp_path / "train"
    base = [sys.executable, "-m", "toc3d_tpu_torch.tools.train",
            "--device", "cpu", "--config", "tiny", "--ann", synth,
            "--batch-size", "1", "--seq-split-num", "1", "--log-interval",
            "1", "--checkpoint-interval", "2", "--src-h", "90", "--src-w",
            "160", "--work-dir", str(work)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(base + ["--iters", "2"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(l) for l in
            (work / "train.log.json").read_text().splitlines()]
    assert [rec["iter"] for rec in recs] == [1, 2]
    for rec in recs:
        assert np.isfinite(rec["total_loss"]) and rec["total_loss"] > 0
        assert rec["nonfinite_skips"] == 0
        assert all(np.isfinite(v) for k, v in rec.items()
                   if isinstance(v, float))
    assert (work / "iter_2.pth").exists() and (work / "final.pth").exists()

    from toc3d_tpu_torch.tools import train as cli
    out = cli.main(["--device", "cpu", "--config", "tiny", "--ann", synth,
                    "--batch-size", "1", "--seq-split-num", "1",
                    "--log-interval", "1", "--checkpoint-interval", "9",
                    "--src-h", "90", "--src-w", "160", "--iters", "3",
                    "--work-dir", str(tmp_path / "resumed"),
                    "--resume-from", str(work / "iter_2.pth"),
                    "--val-ann", synth, "--eval-limit", "4"])
    assert [rec["iter"] for rec in out["records"]] == [3]
    assert out["state"].step == 3
    assert set(out["evals"]) == {3}
    assert 0.0 <= out["evals"][3]["mAP"] <= 1.0
