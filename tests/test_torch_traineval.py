"""The port's closed loop (toc3d_tpu_torch/tools/traineval.py, the twin of
tools/traineval_closedloop.py) on the CPU: the tiny preset on 2 learnable
synthetic scenes x 2 frames, 8 iterations, saved and restored into a
fresh state at 4, evaluated at 0 and 8.

Holds: the JSON line's fields (JAX's, plus device and matcher) and
``resumed``; the resumed run's losses equal, within 1e-6, to those of the
same run without the save and restore (moments, step, bank and the
sampler's place all carried across); the batches built in the child
process equal to the same generator run in this process; the CLI's --out
file; the card as the default device. The mAP bar of the proof lives on
the card (tests/test_torch_traineval_cuda.py, chip_smoke.py).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toc3d_tpu_torch.tools import traineval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--config", "tiny", "--iters", "8",
        "--scenes", "2", "--frames-per-scene", "2", "--eval-points", "1",
        "--src-h", "90", "--src-w", "160"]
FIELDS = ("metric", "value", "unit", "vs_baseline", "steps", "resumed",
          "map_trajectory", "loss_first5_mean", "loss_last5_mean",
          "samples", "lr", "wall_s", "device", "matcher")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
    d = tmp_path_factory.mktemp("traineval")
    make_learnable_dataset(str(d), n_scenes=2, frames_per_scene=2, n_cams=2,
                           src_h=90, src_w=160, n_objects=4, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def runs(data_dir):
    resumed = traineval.main(ARGS + ["--data-dir", data_dir])
    plain = traineval.main(ARGS + ["--data-dir", data_dir], resume=False)
    return resumed, plain


def test_record_fields(runs):
    rec = runs[0]["record"]
    assert tuple(rec) == FIELDS
    assert rec["resumed"] is True and rec["steps"] == 8
    assert rec["device"] == "cpu" and rec["matcher"] == "callback"
    assert rec["samples"] == 4 and rec["unit"] == "mAP"
    traj = rec["map_trajectory"]
    assert [p["iter"] for p in traj] == [0, 8]
    for p in traj:
        for k in ("mAP", "NDS", "mAP_present", "NDS_present"):
            assert math.isfinite(p[k]) and 0.0 <= p[k] <= 1.0
    assert rec["value"] == traj[-1]["mAP"]
    losses = runs[0]["losses"]
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    assert rec["loss_first5_mean"] == round(float(np.mean(losses[:5])), 3)
    assert rec["loss_last5_mean"] == round(float(np.mean(losses[-5:])), 3)


def test_resumed_losses_equal_unresumed(runs):
    resumed, plain = runs
    assert plain["record"]["resumed"] is False
    np.testing.assert_allclose(resumed["losses"], plain["losses"],
                               rtol=1e-6, atol=0)
    assert resumed["record"]["map_trajectory"] == \
        plain["record"]["map_trajectory"]


def test_batch_process_equals_generator(data_dir):
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.data.nuscenes import AugConfig
    cfg = get_config("tiny")
    s = max(64 / 90, 128 / 160)
    aug = AugConfig(final_dim=cfg.pad_shape, H=90, W=160, rand_flip=False,
                    resize_lim=(s, s))
    pkl = os.path.join(data_dir, "infos.pkl")
    args = (pkl, aug, 2, 0, cfg.head.dn_max_gt)
    gen = traineval.train_batches(*args)
    with traineval.BatchProcess(*args) as child:
        for _ in range(3):
            a, b = next(child), next(gen)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_batch_process_raises_when_child_dies(tmp_path):
    with traineval.BatchProcess(str(tmp_path / "missing.pkl"), None, 1, 0,
                                4) as child:
        with pytest.raises(RuntimeError, match="exited with code"):
            next(child)


def test_cli_writes_json_line(data_dir, tmp_path):
    out = tmp_path / "te.json"
    r = subprocess.run([sys.executable, "-m", "toc3d_tpu_torch.tools.traineval",
                        *ARGS, "--iters", "2", "--data-dir", data_dir,
                        "--out", str(out)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == rec
    assert rec["steps"] == 2 and rec["resumed"] is True


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traineval.main(["--iters", "1"])
