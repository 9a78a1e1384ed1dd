"""The port's training bench and the trainer CLI's 1600x800 flags, on the CPU
at the ``tiny`` preset.

* ``python -m toc3d_tpu_torch.bench --train`` (bench.py --train's twin,
  :86-178): its last line is one JSON record with JAX's keys (bench.py:
  153-177) and the port's two (peak_gib, nvidia_smi; null on the CPU), with
  finite losses and the metric's suffixes, plain and with --view-scan on
  --attn-chunk 1.
* ``tools.train``: --view-scan / --view-chunk / --attn-chunk reach
  make_train_step as JAX's tools/train.py:192-207 passes them, also in a
  run of the CLI; --split-step is an argparse error that says it is not
  ported.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu_torch import bench
from toc3d_tpu_torch.data.synthetic import make_learnable_dataset
from toc3d_tpu_torch.runtime import train as tt
from toc3d_tpu_torch.tools import train as cli

JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "steps",
            "nonfinite_skips", "loss_finite", "loss_first5_mean",
            "loss_last5_mean", "loss_decreasing", "loss_trace_every5"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps in one thread: under the suite's parallel workers
    more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags,suffix", [
    ([], ""),
    (["--view-scan", "on", "--attn-chunk", "1"], "+vscanTrue+achunk1")])
def test_bench_train_prints_jax_record(capsys, flags, suffix):
    """max(frames // 2, 50) = 50 timed steps after 3 to settle on the
    fixed batch: finite losses and gradient norms, no skip, one loss every
    fifth step in the trace; plain, and with the view scan and the chunked
    attention (--view-chunk's suffix: test_train_label_matches_jax_suffixes)."""
    rc = bench.main(["--train", "--config", "tiny", "--device", "cpu",
                     "--frames", "2"] + flags)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    rec = json.loads(out[-1])
    assert set(rec) == JAX_KEYS | {"peak_gib", "nvidia_smi"}
    assert rec["metric"] == f"tiny train step/s (batch 1){suffix}"
    assert rec["unit"] == "steps/s" and rec["value"] > 0
    assert rec["steps"] == 50 and len(rec["loss_trace_every5"]) == 10
    assert rec["loss_finite"] and rec["nonfinite_skips"] == 0
    assert np.isfinite([rec["loss_first5_mean"], rec["loss_last5_mean"]]
                       + rec["loss_trace_every5"]).all()
    assert rec["peak_gib"] is None and rec["nvidia_smi"] is None


def test_train_label_matches_jax_suffixes():
    """bench.py's metric suffixes (:156-161) for the queue and no-remat."""
    args = SimpleNamespace(queue_length=2, no_remat=True)
    assert bench.train_label(args, "X", 2, True, 32) == \
        "X train step/s (batch 2)+vscanTrue+achunk32+queue2+noremat"
    assert bench.train_label(args, "X", 2, False, None) == \
        "X train step/s (batch 2)+queue2+noremat"
    plain = SimpleNamespace(queue_length=0, no_remat=False)
    assert bench.train_label(plain, "X", 1, 3, None) == \
        "X train step/s (batch 1)+vscan3"


BASE = ["--config", "tiny", "--ann", "x.pkl", "--device", "cpu"]


@pytest.mark.parametrize("flags,want", [
    ([], {"view_scan": None, "attn_chunk": None}),
    (["--view-scan", "on"], {"view_scan": True, "attn_chunk": None}),
    (["--view-scan", "off", "--attn-chunk", "32"],
     {"view_scan": False, "attn_chunk": 32}),
    (["--view-scan", "off", "--view-chunk", "3"],
     {"view_scan": 3, "attn_chunk": None})])
def test_train_cli_step_options(flags, want):
    assert cli.step_options(cli.parse_args(BASE + flags)) == want


def test_train_cli_split_step_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(BASE + ["--split-step"])
    assert e.value.code == 2
    assert "--split-step is not ported" in capsys.readouterr().err


def test_train_cli_flags_reach_make_train_step(tmp_path, monkeypatch):
    """One iteration of the CLI with --view-chunk 1 --attn-chunk 1 on the
    synthetic scenes' two views: the options reach make_train_step and the
    step trains (a finite logged loss)."""
    seen = {}
    real = tt.make_train_step

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(tt, "make_train_step", spy)
    ann = make_learnable_dataset(str(tmp_path / "synth"), n_scenes=1,
                                 frames_per_scene=2, src_h=90, src_w=160)
    out = cli.main(["--device", "cpu", "--config", "tiny", "--ann", ann,
                    "--iters", "1", "--batch-size", "1", "--seq-split-num",
                    "1", "--log-interval", "1", "--checkpoint-interval", "9",
                    "--src-h", "90", "--src-w", "160", "--work-dir",
                    str(tmp_path / "work"), "--view-chunk", "1",
                    "--attn-chunk", "1"])
    assert seen["view_scan"] == 1 and seen["attn_chunk"] == 1
    assert np.isfinite(out["records"][0]["total_loss"])
