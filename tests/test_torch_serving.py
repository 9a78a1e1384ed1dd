"""The port's serving path on the CPU: ``make_infer_fn`` against the JAX
package's ``make_infer_fn`` (its two jitted programs) at the `tiny` preset in
f32, with prev_exists handed over as a host (numpy) array, over a stream
with a scene reset and over a mixed batch (one lane starting a scene, one
continuing it: JAX's lax.cond then takes the blended selector branch). The
same reference-named state dict feeds both packages. Tolerances as
tests/test_torch_detector.py: scores and boxes 1e-3, labels and valid
equal, every memory-bank field 1e-3.

Also: a steady frame builds no constant from the host (no torch.tensor,
torch.from_numpy or device-naming .to on the path after the first frame),
and the port's bench (toc3d_tpu_torch/bench.py) keeps bench.py's frame
schedule and ends in its JSON line.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.models.detector import make_infer_fn as jax_make_infer_fn
from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint

from test_full_converter import build_reference_state_dict
from test_parity_detector import make_frames

from toc3d_tpu_torch import bench
from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.models import detector as td

ROOT = Path(__file__).resolve().parents[1]
BANK = ("embedding", "reference_point", "timestamp", "egopose", "velo")


def _models(seed):
    jcfg = jax_get_config("tiny")
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone, mxu_align_k=True))
    tcfg = get_config("tiny")
    tcfg = replace(tcfg, backbone=replace(tcfg.backbone, mxu_align_k=True))
    rng = np.random.RandomState(seed)
    sd = build_reference_state_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    return jcfg, params, model, rng


def _host_frame(frame):
    """Tensors on the CPU for everything but prev_exists, which stays a
    numpy array, as a server that builds its frames on the host holds
    it."""
    out = td.frame_to_device({k: v for k, v in frame.items()
                              if k != "prev_exists"}, "cpu")
    out["prev_exists"] = frame["prev_exists"]
    return out


def _stream_against_jax(prev, batch, seed):
    """Stream len(prev) frames (prev[t]: prev_exists of frame t, one value
    per lane) through both make_infer_fns and compare every frame."""
    jcfg, params, model, rng = _models(seed)
    frames = make_frames(rng, jcfg, t_total=len(prev), b=batch)
    for f, pe in zip(frames, prev):
        f["prev_exists"] = np.asarray(pe, np.float32)
    jinfer = jax_make_infer_fn(jcfg)
    tinfer = td.make_infer_fn(model)
    jstate = jax_init_state(batch, jcfg)
    tstate = td.init_state(batch, model.cfg, device="cpu")
    for t, frame in enumerate(frames):
        jstate, jdet = jinfer(params, jstate,
                              {k: jnp.asarray(v) for k, v in frame.items()})
        tstate, tdet = tinfer(tstate, _host_frame(frame))
        for lane in range(batch):
            msg = f"frame {t} lane {lane}"
            np.testing.assert_allclose(tdet.scores[lane].numpy(),
                                       np.asarray(jdet.scores[lane]),
                                       atol=1e-3, err_msg=f"{msg} scores")
            np.testing.assert_allclose(tdet.bboxes[lane].numpy(),
                                       np.asarray(jdet.bboxes[lane]),
                                       atol=1e-3, rtol=1e-3,
                                       err_msg=f"{msg} boxes")
            assert (tdet.labels[lane].numpy()
                    == np.asarray(jdet.labels[lane])).all(), msg
            assert (tdet.valid[lane].numpy()
                    == np.asarray(jdet.valid[lane])).all(), msg
            for name in BANK:
                np.testing.assert_allclose(
                    getattr(tstate.memory, name)[lane].numpy(),
                    np.asarray(getattr(jstate.memory, name)[lane]),
                    atol=1e-3, err_msg=f"{msg} memory {name}")


def test_make_infer_fn_stream_with_reset_matches_jax():
    """prev_exists 0, 1, 1, 0, 1: a scene reset at frame 3 takes the
    first-frame branch again and refreshes the bank."""
    _stream_against_jax([[0.0], [1.0], [1.0], [0.0], [1.0]], 1, 7)


def test_make_infer_fn_mixed_batch_matches_jax():
    """Two lanes, prev_exists [0, 0], [1, 0], [1, 1]: the mixed frame
    blends the score MLP and the query scores per lane."""
    _stream_against_jax([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], 2, 11)


def test_steady_frame_builds_no_constant(monkeypatch):
    """After a first frame has built the per-frame constants (normalisation,
    resize matrices, ranges, grids), a frame whose tensors already lie on
    the model's device makes no torch.tensor, torch.from_numpy or
    device-naming .to call."""
    cfg = get_config("tiny")
    model = td.build_detector(cfg, device="cpu", seed=1)
    infer = td.make_infer_fn(model)
    rng = np.random.RandomState(3)
    frames = make_frames(rng, cfg, t_total=3)
    for f in frames:
        f["img"] = rng.randint(0, 256, f["img"].shape).astype(np.uint8)
    frames = [td.frame_to_device(f, "cpu") for f in frames]
    state = td.init_state(1, cfg, device="cpu")
    state, _ = infer(state, frames[0])
    state, _ = infer(state, frames[1])
    calls = []
    tensor, from_numpy, to = torch.tensor, torch.from_numpy, torch.Tensor.to

    def count_tensor(*a, **kw):
        calls.append("torch.tensor")
        return tensor(*a, **kw)

    def count_from_numpy(*a, **kw):
        calls.append("torch.from_numpy")
        return from_numpy(*a, **kw)

    def count_to(self, *a, **kw):
        if "device" in kw or any(isinstance(x, (str, torch.device))
                                 for x in a):
            calls.append(".to(device)")
        return to(self, *a, **kw)

    monkeypatch.setattr(torch, "tensor", count_tensor)
    monkeypatch.setattr(torch, "from_numpy", count_from_numpy)
    monkeypatch.setattr(torch.Tensor, "to", count_to)
    state, det = infer(state, frames[2])
    monkeypatch.undo()
    assert calls == []
    assert torch.isfinite(det.scores).all()


@pytest.fixture
def cuda_standins(monkeypatch):
    """CPU stand-ins for the CUDA stream and graph calls of
    runtime/graphs.py: a capture runs its function (on the CPU it computes)
    and a replay does nothing, so a test sees which programs
    CapturedInfer captures, keeps and drops, not what a replay computes
    (the card tests check that)."""
    import contextlib

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


def test_captured_programs_are_kept_until_weights_or_layout_change(
        cuda_standins):
    """Over a stream with a scene reset each program (backbone + neck per
    steady value, head + decode) is captured once, at its first use, and
    kept: the bank a frame returns has other strides than init_state's
    and must not count as a new layout. New weights (load_state_dict) or
    a frame of another batch drop the programs and capture again."""
    from toc3d_tpu_torch.runtime.graphs import CapturedInfer
    cfg = get_config("tiny")
    model = td.build_detector(cfg, device="cpu", seed=1)
    infer = CapturedInfer(model)
    g = torch.Generator().manual_seed(4)

    def frame(t, pe, b=1):
        f = td.synthetic_frame(g, t, batch=b, views=2, height=64, width=128,
                               device="cpu")
        f["prev_exists"] = torch.full((b,), pe)
        return f

    state = td.init_state(1, cfg, device="cpu")
    seen = {}
    for t, pe in enumerate((0.0, 1.0, 1.0, 0.0, 1.0)):
        state, det = infer(state, frame(t, pe))
        for name, prog in infer._programs.items():
            assert seen.setdefault(name, prog) is prog, (t, name)
    assert set(map(str, seen)) == {str(("backbone+neck", False)),
                                   str(("backbone+neck", True)),
                                   "head+decode"}
    assert torch.isfinite(det.scores).all()
    model.load_state_dict(td.build_detector(cfg, device="cpu",
                                            seed=2).state_dict())
    infer(state, frame(5, 1.0))
    assert infer._programs["head+decode"] is not seen["head+decode"]
    assert list(infer._programs)[0] == ("backbone+neck", True)
    kept = infer._programs["head+decode"]
    infer(td.init_state(2, cfg, device="cpu"), frame(6, 1.0, b=2))
    assert infer._programs["head+decode"] is not kept


def test_is_steady_reads_the_host_copy():
    """The first-frame branch is all(prev_exists > 0), read from a numpy
    array or a host tensor as from a device one."""
    for pe, want in (([1.0, 1.0], True), ([1.0, 0.0], False),
                     ([0.0], False)):
        a = np.asarray(pe, np.float32)
        assert td.is_steady({"prev_exists": a}) is want
        assert td.is_steady({"prev_exists": torch.from_numpy(a)}) is want


def test_bench_schedule():
    """bench.py's schedule: prev_exists 0 on every 40th frame, the 4
    contents cycled."""
    sched = [bench.schedule(i) for i in range(120)]
    assert [i for i, (_, pe) in enumerate(sched) if pe == 0.0] == [0, 40, 80]
    assert [c for c, _ in sched[:9]] == [0, 1, 2, 3, 0, 1, 2, 3, 0]
    rng = np.random.RandomState(0)
    f = bench.make_frame(rng, 1, 6, 64, 128, 0.0, pin=False)
    assert f["img"].dtype == torch.uint8
    assert tuple(f["img"].shape) == (1, 6, 64, 128, 3)
    assert f["prev_exists"].tolist() == [0.0]
    assert bench.A100_PIPELINE_MS["ToC3D_faster_1600"] == 878.5


def test_bench_runs_on_cpu_and_ends_in_its_json_line():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    r = subprocess.run(
        [sys.executable, "-m", "toc3d_tpu_torch.bench", "--device", "cpu",
         "--config", "tiny", "--warmup", "1", "--frames", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "frames/s" and last["value"] > 0
    assert last["metric"] == "tiny 6-view frames/sec/cpu"
    assert any("backbone+neck" in x for x in lines)
    assert any("head+decode" in x for x in lines)
