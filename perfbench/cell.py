"""One run of one cell: set-up, the measured window, the traced frames (with
--trace 1), the comparison with the reference, and the result line.

Set-up: the program's kernels are built (served from the checkout's build
directory after the cell's first run there), the weights drawn on the
device from the seed, the detector built from them, the frames built on
the host, and the traffic's warm frames streamed through the entry point,
which captures both of its programs. The window then streams frames for
``seconds``: frame t is queued before frame t-1's boxes are awaited, and
the window ends when the last frame's boxes are on the host.
"""
from __future__ import annotations

import gc
import json
import os
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

from . import check, program, traffic, weights

PKG = Path(__file__).resolve().parent


def process_start() -> float:
    """The process's start on time.time()'s clock (from /proc), or now."""
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(stat[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


class Run:
    """What one run measured (read by perfbench/end_to_end)."""
    frames = 0
    window_s = 0.0
    latency_s = ()
    peak_bytes = None
    setup_s = None


class Context:
    """What the per-layer readers read (perfbench/metrics)."""


def fetch_start(det):
    """Queue the copy of one frame's boxes into pinned host memory behind
    the frame; (host tensors, event) for ``fetch_wait``."""
    import torch
    if not det.scores.is_cuda:
        return det, None
    host = type(det)(*(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       .copy_(t, non_blocking=True) for t in det))
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def fetch_wait(pending):
    """Wait for that frame's copy alone; (bboxes, scores, labels) as
    numpy."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return (host.bboxes.numpy().copy(), host.scores.numpy().copy(),
            host.labels.numpy().copy())


def stream(infer, frames, state, first: int, stop, on_issue=None,
           annotate=False):
    """Stream frames first, first + 1, ... until ``stop(count)``; frame t
    is queued before t-1's boxes are awaited. Returns (state, outputs by
    index, issue times, done times, host seconds of each step)."""
    import torch
    mark = (lambda name: torch.profiler.record_function(name)) if annotate \
        else (lambda name: nullcontext())
    outputs, issued, done, step_s = {}, [], [], []
    pending, i = None, first
    while not stop(i - first):
        if on_issue is not None:
            on_issue(i, state)
        t = time.perf_counter()
        with mark("perfbench.step"):
            state, det = infer(state, frames(i))
        step_s.append(time.perf_counter() - t)
        issued.append(t)
        fetch = fetch_start(det)
        if pending is not None:
            with mark("perfbench.fetch_wait"):
                outputs[i - 1] = fetch_wait(pending)
            done.append(time.perf_counter())
        pending, i = fetch, i + 1
    if pending is not None:
        with mark("perfbench.fetch_wait"):
            outputs[i - 1] = fetch_wait(pending)
        done.append(time.perf_counter())
    return state, outputs, issued, done, step_s


def load_cell(bench: dict, workload: str, root: Path):
    """(workload entry, configuration file, traffic, limits) by name."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_file = json.loads((root / conf["file"]).read_text())
    params = traffic.load(cell["traffic"], root)
    limits = json.loads((root / "perfbench" / "cells" / f"{workload}.json")
                        .read_text())
    return cell, cfg_file, params, limits["limits"]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: Path = PKG.parent,
             control: bool = False, wrap_entry=None, t_start=None):
    """One run; returns (result dict, [(check name, value, limit)]).
    ``control``: the program's own int8 path in its place (the control of
    the comparison); ``wrap_entry``: a function of the entry point that
    returns the one to drive (tests plant faults with it)."""
    import torch
    t_start = process_start() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell, cfg_file, params, limits = load_cell(bench, workload, root)
    batch, views = params["batch"], params["views"]
    if views != cfg_file["views"]:
        raise ValueError(f"traffic {cell['traffic']!r} has {views} views, "
                         f"configuration {cfg_file['name']!r} "
                         f"{cfg_file['views']}")
    cfg = program.program_config(cfg_file, control)
    if cuda:
        program.build_kernels()
    sd = weights.make_state_dict(cfg_file, seed, device)
    model = program.detector(cfg, sd, device)
    del sd
    timer = program.stage_timer(device) if trace else None
    infer = program.entry(model, timer)
    if wrap_entry is not None:
        infer = wrap_entry(infer)
    frames = traffic.Stream(params, cfg_file, seed, pin=cuda)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = program.initial_state(cfg, batch, device)
    warm = len(params["warm"])
    state, *_ = stream(infer, frames.warm_frame, state, 0,
                       lambda k: k >= warm)
    if cuda:
        torch.cuda.synchronize()
    if timer is not None:
        timer.reset()

    run = Run()
    run.setup_s = time.time() - t_start
    rng = np.random.default_rng([int(seed), 1])
    scene = params["scene_len"]
    starts = check.Reservoir(rng, params["check_scene_starts"],
                             lambda i: i % scene == 0)
    mids = check.Reservoir(rng, params["check_mid_frames"],
                           lambda i: i % scene != 0)

    def offer(i, state):
        starts.offer(i, state)
        mids.offer(i, state)
    w0 = time.perf_counter()
    end = w0 + seconds
    state, outputs, issued, done, step_s = stream(
        infer, frames.frame, state, 0, lambda k: time.perf_counter() >= end,
        on_issue=offer)
    run.frames = len(issued)
    starts.close(run.frames - 1, state)
    mids.close(run.frames - 1, state)
    run.window_s = done[-1] - w0
    run.latency_s = [d - t for t, d in zip(issued, done)]
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else None

    ctx = None
    if trace:
        ctx = Context()
        ctx.cfg, ctx.views, ctx.batch = cfg_file, views, batch
        ctx.step_s, ctx.frames, ctx.window_s = step_s, run.frames, \
            run.window_s
        ctx.stages = timer.samples()
        ctx.kernels, ctx.host, ctx.trace_frames = [], [], 0
        ctx.trace_s = ctx.busy_s = 0.0
        if cuda:
            _trace(ctx, infer, frames, state, run.frames,
                   params["trace_frames"])
    failed = sum(1 for o in outputs.values()
                 if not (np.isfinite(o[0]).all() and np.isfinite(o[1]).all()))

    # the reference runs on the program's outputs once the program is gone
    del infer, model, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sd = weights.make_state_dict(cfg_file, seed, device)
    judged = check.run_reference(sd, cfg_file, frames, device,
                                 starts.items + mids.items, outputs, batch,
                                 program.bank_of)
    checks = []
    for name in limits:
        value = max(n[name] for _, _, n in judged) if judged else float("inf")
        checks.append((name, value, limits[name]))
    correct = failed == 0 and run.frames > 0 and len(judged) > 0 and all(
        v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": run.frames,
              "failed": failed, "metrics": {},
              "device": _device(cuda, run.peak_bytes)}
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    for m in wanted:
        if workload not in m.get("workloads", [workload]):
            continue
        if trace:
            from . import metrics
            value = metrics.load(m["name"]).read(ctx)
        else:
            from . import end_to_end
            value = end_to_end.load(m["name"]).read(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    if trace and cuda:
        from . import trace as tr
        result["device"]["busy_s"] = ctx.busy_s
        result["device"]["window_s"] = ctx.trace_s
        t0, t1 = ctx.span
        result["breakdown"] = {
            "device_ops": tr.top_ops(ctx.kernels),
            "idle_gaps": tr.idle_gaps(ctx.kernels, ctx.host, t0, t1)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    result["_judged"] = judged
    return result, checks


def _trace(ctx, infer, frames, state, first, count):
    """Stream ``count`` frames after the window under torch.profiler and
    reduce the trace into ctx."""
    import torch
    from . import trace as tr
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("perfbench.trace"):
            stream(infer, frames.frame, state, first,
                   lambda k: k >= count, annotate=True)
            torch.cuda.synchronize()
    ctx.kernels, ctx.host = tr.reduce(prof)
    span = next(h for h in ctx.host if h[0] == "perfbench.trace")
    ctx.span = (span[1], span[2])
    ctx.trace_frames = count
    ctx.trace_s = (span[2] - span[1]) * 1e-6
    ctx.busy_s = tr.busy_seconds(ctx.kernels, span[1], span[2])


def _device(cuda: bool, peak):
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
