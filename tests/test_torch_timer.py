"""The stage timer (toc3d_tpu_torch/runtime/timer.py) on the CPU, where its
stamp log takes the host clock: nested spans and the model's stages
("backbone+neck/select" a token selector, "backbone+neck/neck" the neck,
"head+decode/decoder") in an eager stream and in a traced tiny run of the
benchmark, each child inside
its parent, outputs untouched by timing, ``stage`` doing nothing without a
timer or under torch.export, a full log reported, and a captured program
keeping the timer its stamps write into. The card's own checks (in-graph
stamps on replays, no host sync, the profiler's stamp kernels, CUDA events)
are in tests/test_torch_timer_cuda.py."""
import json
import shutil

import pytest
import torch

from perfbench import program
from perfbench.cell import run_cell
from perfbench.tests.conftest import REPO, TINY_CELL, add_tiny_cell
from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.runtime.timer import (StageTimer, current, span, stage,
                                           tree)

from test_torch_serving import cuda_standins  # noqa: F401

STAGES = ("inputs", "backbone+neck", "backbone+neck/select",
          "backbone+neck/neck", "head+decode", "head+decode/decoder")


def _frames(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, w = cfg.pad_shape
    return [td.synthetic_frame(g, t, height=h, width=w, device="cpu")
            for t in range(n)]


def _stream(model, cfg, frames, timer):
    state = td.init_state(1, cfg, device="cpu")
    dets = []
    for f in frames:
        state, det = td.infer_step(model, state, f, timer=timer)
        dets.append(det)
    return state, dets


def _assert_nested(spans, frames, selectors):
    """Each frame's parents hold their children: ``selectors`` selects a
    'backbone+neck', one decoder a 'head+decode', and no child lies
    outside a parent."""
    by = {}
    for path, t0, t1 in spans:
        assert t0 <= t1
        by.setdefault(path, []).append((t0, t1))
    assert len(by["inputs"]) == frames
    for parent, child, per in (("backbone+neck", "select", selectors),
                               ("head+decode", "decoder", 1)):
        assert len(by[parent]) == frames
        kids = by[f"{parent}/{child}"]
        assert len(kids) == per * frames
        for p0, p1 in by[parent]:
            assert sum(p0 <= c0 and c1 <= p1 for c0, c1 in kids) == per


def test_eager_stream_records_each_stage_inside_its_parent():
    cfg = get_config("tiny")
    selectors = len(cfg.backbone.pruning_loc)
    model = td.build_detector(cfg, device="cpu", seed=0)
    timer = StageTimer("cpu")
    _stream(model, cfg, _frames(cfg, 3), timer)
    spans = timer.spans()
    _assert_nested(spans, 3, selectors)
    assert set(timer.samples()) == set(STAGES)
    assert current() is None
    timer.reset()
    assert timer.samples() == {}


def test_timing_leaves_outputs_and_bank_bit_identical():
    cfg = get_config("tiny")
    model = td.build_detector(cfg, device="cpu", seed=2)
    frames = _frames(cfg, 3, seed=2)
    s0, d0 = _stream(model, cfg, frames, None)
    s1, d1 = _stream(model, cfg, frames, StageTimer("cpu"))
    for a, b in zip(s0.memory, s1.memory):
        assert torch.equal(a, b)
    for x, y in zip(d0, d1):
        for a, b in zip(x, y):
            assert torch.equal(a, b)


def test_traced_tiny_cell_reports_the_stage_metrics(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = add_tiny_cell(root, json.loads(
        (REPO / "BENCHMARK.json").read_text()))
    made = []

    def keep(device):
        made.append(StageTimer(device))
        return made[-1]
    monkeypatch.setattr(program, "stage_timer", keep)
    res, _ = run_cell(bench, TINY_CELL, 4000000003, 0.5, True, "cpu", root)
    assert res["correct"]
    for name in ("inputs_ms", "selector_ms", "decoder_ms", "head_glue_ms",
                 "backbone_neck_ms", "head_decode_ms"):
        assert res["metrics"][name]["value"] > 0, name
    m = res["metrics"]
    assert m["selector_ms"]["value"] < m["backbone_neck_ms"]["value"]
    assert m["head_glue_ms"]["value"] == pytest.approx(
        m["head_decode_ms"]["value"] - m["decoder_ms"]["value"])
    selectors = len(get_config("tiny").backbone.pruning_loc)
    _assert_nested(made[0].spans(), res["attempted"], selectors)


def test_spans_nest_and_restore_the_current_timer():
    outer, inner = StageTimer("cpu"), StageTimer("cpu")
    with stage("nothing"):
        pass
    with outer.span("a"):
        assert current() is outer
        with stage("b"):
            with stage("c"):
                pass
        with inner.span("x"):
            assert current() is inner
            with stage("y"):
                pass
        assert current() is outer
        with pytest.raises(ValueError):
            with stage("failed"):
                raise ValueError
        with span(None, "untimed"):
            pass
    assert current() is None
    assert {p: len(x) for p, x in outer.samples().items()} == {
        "a": 1, "a/b": 1, "a/b/c": 1}
    assert set(inner.samples()) == {"x", "x/y"}
    lines = tree({"a": [2.0], "a/b": [1.0, 3.0], "c": [4.0]})
    assert lines == ["a: mean 2.000 ms  min 2.000  max 2.000  (n=1)",
                     "  b: mean 2.000 ms  min 1.000  max 3.000  (n=2)",
                     "c: mean 4.000 ms  min 4.000  max 4.000  (n=1)"]


class _Staged(torch.nn.Module):
    def forward(self, x):
        with stage("inside"):
            return x + 1


def test_stage_does_nothing_under_export():
    timer = StageTimer("cpu")
    x = torch.ones(3)
    with timer.span("outer"):
        torch.export.export(_Staged(), (x,))
    assert set(timer.samples()) == {"outer"}
    with timer.span("outer"):
        _Staged()(x)
    assert timer.summary()["outer/inside"]["n"] == 1


def test_full_log_is_reported_not_wrapped():
    timer = StageTimer("cpu", capacity=4)
    for name in ("a", "b", "c"):
        with timer.span(name):
            pass
    with pytest.raises(RuntimeError, match="dropped 2 stamps"):
        timer.samples()
    timer.reset()
    with timer.span("d"):
        pass
    assert set(timer.samples()) == {"d"}


def test_captured_programs_keep_the_timer_they_stamp(cuda_standins):
    from toc3d_tpu_torch.runtime.graphs import CapturedInfer
    cfg = get_config("tiny")
    model = td.build_detector(cfg, device="cpu", seed=1)
    frames = _frames(cfg, 2, seed=1)
    for timer in (StageTimer("cpu"), None):
        infer = CapturedInfer(model, timer)
        state = td.init_state(1, cfg, device="cpu")
        for f in frames:
            state, _ = infer(state, f)
        assert len(infer.runner.programs) == 3
        assert all(p.timer is timer
                   for p in infer.runner.programs.values())
    infer = CapturedInfer(model)
    outer = StageTimer("cpu")
    with outer.span("caller"):
        infer(td.init_state(1, cfg, device="cpu"), frames[0])
    assert all(p.timer is outer for p in infer.runner.programs.values())
