"""The stage timer on the card (toc3d_tpu_torch/runtime/timer.py and the
stamp kernel, csrc/stamp.cu): ToC3D_faster_1600 at 1600x800, served as
captured CUDA graphs with a timer, gives every in-graph span once a replay
("backbone+neck/select" once a selector), queues a steady frame with no host
sync, and its log agrees with the profiler's stamp kernels (within 2 us,
once the trace's clock rate is fitted) and with CUDA events around the same
replays (within 1%). A traced run of
each benchmark cell reports the stage metrics. The CPU side is
tests/test_torch_timer.py.

Every test needs a CUDA card and skips without one. This file imports no
JAX (hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_timer_cuda.py -q
"""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
REPLAYS = 20


@pytest.fixture(scope="module")
def served():
    """ToC3D_faster_1600 behind make_infer_fn with a stage timer, its
    programs captured (a first frame, then two steady ones), and a pinned
    steady frame to replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn,
                                                 synthetic_frame)
    from toc3d_tpu_torch.runtime.timer import StageTimer
    cfg = get_config("ToC3D_faster_1600")
    model = build_detector(cfg, device="cuda", seed=0)
    timer = StageTimer("cuda")
    infer = make_infer_fn(model, timer)
    g = torch.Generator().manual_seed(0)
    frames = [{k: v.pin_memory() for k, v in
               synthetic_frame(g, t, device="cpu").items()} for t in range(4)]
    s = SimpleNamespace(cfg=cfg, timer=timer, infer=infer, frame=frames[3],
                        state=init_state(1, cfg, device="cuda"))
    for f in frames[:3]:
        s.state, _ = infer(s.state, f)
    torch.cuda.synchronize()
    return s


def _replay(s, n):
    for _ in range(n):
        s.state, det = s.infer(s.state, s.frame)
    return det


def test_every_in_graph_span_is_stamped_on_each_replay(served):
    served.timer.reset()
    _replay(served, REPLAYS)
    spans = served.timer.spans()
    selectors = len(served.cfg.backbone.pruning_loc)
    counts = {}
    for path, _, _ in spans:
        counts[path] = counts.get(path, 0) + 1
    assert counts == {"inputs": REPLAYS, "backbone+neck": REPLAYS,
                      "backbone+neck/select": selectors * REPLAYS,
                      "backbone+neck/neck": REPLAYS,
                      "head+decode": REPLAYS,
                      "head+decode/decoder": REPLAYS}
    for parent, child, per in (("backbone+neck", "select", selectors),
                               ("head+decode", "decoder", 1)):
        kids = [(a, b) for p, a, b in spans if p == f"{parent}/{child}"]
        for _, p0, p1 in (x for x in spans if x[0] == parent):
            assert sum(p0 <= a and b <= p1 for a, b in kids) == per


def test_a_steady_step_makes_no_host_sync(served):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _replay(served, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_log_spans_match_the_profilers_stamp_kernels(served):
    from perfbench import trace
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    served.timer.reset()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _replay(served, 5)
        torch.cuda.synchronize()
    spans = served.timer.spans()
    kernels, host = trace.reduce(prof)
    starts = [s for name, s, _ in kernels if "stamp_kernel" in name]
    # the log's stamps in stream order; a tie puts an end before a begin
    order = sorted([(t0, 1, k) for k, (_, t0, _) in enumerate(spans)]
                   + [(t1, 0, k) for k, (_, _, t1) in enumerate(spans)])
    assert len(starts) == len(order) == 2 * len(spans)
    at = {(k, kind): i for i, (_, kind, k) in enumerate(order)}
    # the profiler's timeline (the card's timestamps mapped onto the host's
    # clock) has run up to 0.43% off the card's global timer in rate, 158
    # us over a 36 ms span, where CUDA events agree with the log (the test
    # below): take the trace's rate from its own stamps (least squares),
    # hold it to 1% of the log's, and each span to its stamp kernels'
    # starts within 2 us
    x = [(t - order[0][0]) * 1e-3 for t, _, _ in order]
    y = [s - starts[0] for s in starts]
    mx, my = sum(x) / len(x), sum(y) / len(y)
    rate = sum((a - mx) * (b - my) for a, b in zip(x, y)) / \
        sum((a - mx) ** 2 for a in x)
    assert abs(rate - 1) <= 1e-2, rate
    worst = max(abs(rate * (t1 - t0) * 1e-3
                    - (starts[at[k, 0]] - starts[at[k, 1]]))
                for k, (_, t0, t1) in enumerate(spans))
    assert worst <= 2.0, (worst, rate)
    names = {name for name, _, _ in host}
    assert {"toc3d.inputs", "toc3d.backbone+neck",
            "toc3d.head+decode"} <= names


def test_program_spans_agree_with_cuda_events(served):
    """The log's 'backbone+neck' and 'head+decode' against CUDA events
    recorded around the same replays."""
    events = {"backbone+neck": [], "head+decode": []}
    run = served.infer.runner._run

    def timed(name, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run(name, fn)
        b.record()
        events["head+decode" if name == "head+decode"
               else "backbone+neck"].append((a, b))
        return out
    served.infer.runner._run = timed
    try:
        served.timer.reset()
        _replay(served, REPLAYS)
    finally:
        del served.infer.runner._run
    samples = served.timer.samples()
    torch.cuda.synchronize()
    for name, pairs in events.items():
        ev = sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
        log = sum(samples[name]) / len(samples[name])
        assert len(pairs) == len(samples[name]) == REPLAYS
        assert abs(log - ev) <= 0.01 * ev, (name, log, ev)


@pytest.mark.parametrize("workload", ["toc3d_faster_1600.stream_b1",
                                      "streampetr_vitl_1600.stream_b1"])
def test_a_traced_run_reports_the_stage_metrics(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", "4000000021", "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("inputs_ms", "decoder_ms", "head_glue_ms"):
        assert m[name] > 0, name
    if workload.startswith("toc3d"):
        assert 0 < m["selector_ms"] < m["backbone_neck_ms"]
    else:
        assert "selector_ms" not in m
    frames = json.loads((REPO / "perfbench/workloads/stream_b1.json")
                        .read_text())["trace_frames"]
    kernel_d = sum(s for name, s in res["breakdown"]["device_ops"]
                   if "flash" in name)
    assert m["decoder_ms"] >= 1e3 * kernel_d / frames
