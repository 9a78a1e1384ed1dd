"""Benchmark of the PyTorch port on one GPU: streaming inference (the
protocol of bench.py:249-390 and its sweep, :181-230) and training
(bench.py --train, :86-178).

    python3 -m toc3d_tpu_torch.bench [--config ToC3D_faster_1600]
        [--warmup 200] [--frames 100] [--batch 1] [--int8 [--int8-calib N]]
        [--eager] [--device cuda]
    python3 -m toc3d_tpu_torch.bench --sweep [--warmup 200] [--frames 100]
        [--int8] [--eager]
    python3 -m toc3d_tpu_torch.bench --train [--config ToC3D_faster_1600]
        [--batch N] [--frames F] [--view-scan auto|on|off] [--view-chunk N]
        [--attn-chunk N] [--queue-length T] [--no-remat] [--device cuda]

--config takes every preset of configs/presets.py and the ToC3D_ratio*
speed-sweep names (ToC3D_ratio543, ToC3D_ratio543_1600).

The protocol (reference README.md:113-123, gpu_timer.py:29): seeded random
weights; 6 camera views at the preset's pad shape; 4 image contents built on
the host from a seeded numpy generator (as bench.py's make_frame, with uint8
images that the model normalises on the device), each with prev_exists 0 and
1, held in pinned memory; frame i takes content i % 4, and prev_exists 0 on
every SCENE_LEN-th frame (a nuScenes scene is ~40 frames), so the first-frame
branch is paid at the val set's rate. ``warmup`` frames, then ``frames``
timed ones; frame t-1's boxes are fetched to the host while frame t is
queued. On the card the frame runs through the captured ``make_infer_fn``
(``--eager``: through ``infer_step``, for comparison); ``--device cpu``
runs it eagerly (a check of the protocol, not a measurement of a device).

Prints the nvidia-smi name and power limit, the peak device memory, the wall
ms/frame, the per-stage device time from CUDA events (runtime/timer.py;
bench.py has no split, the JAX package's GlobalTimer gives one) and, last,
one JSON line {"metric", "value", "unit", "vs_baseline"}: frames/s against
the paper's A100 whole-pipeline latency.

--sweep benches each config of SWEEP_FAMILIES (the paper's Table 2 rows:
StreamPETR, ToC3D-Fast and ToC3D-Faster for ViT-L at 800x320 and 1600x800
and for ViT-B at 800x320) in its own process, with the same options, and
prints the nvidia-smi line and one table: ms/frame, frames/s, the speedup
over the family's StreamPETR baseline and the peak device memory, beside
the paper's A100 latency of the same config. It writes no file.

--train times the full train step (runtime/train.make_train_step: grid
mask, the backbone with token selection, the 2D head, DN, the matching,
the losses, the backward, AdamW) on one fixed synthetic batch
(make_train_batch, bench.py:64-84; 6 views at the preset's pad shape,
--batch lanes, seeded random weights), as bench.py does: 3 steps to settle,
then max(frames // 2, 50) timed steps, the device read only every 10 steps.
The view scan follows --view-scan / --view-chunk (auto: JAX's policy, on at
1600x800 unless --attn-chunk is given), --attn-chunk chunks the backbone's
model-path attention, --queue-length T > 1 trains on T consecutive frames
(compute_losses_multiframe), --no-remat drops the droppath blocks' and
decoder layers' checkpoints. Its last line is bench.py's JSON record
(metric, value in steps/s, unit, vs_baseline, steps, nonfinite_skips,
loss_finite, loss_first5_mean, loss_last5_mean, loss_decreasing,
loss_trace_every5) with peak_gib and nvidia_smi added; on the CPU (for
tests) both are null.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# A100 whole-pipeline latency (ms) per config, BASELINE.md / paper Table 2
# (copied from bench.py:21-31)
A100_PIPELINE_MS = {
    "stream_petr_eva_vit_l": 317.0,
    "ToC3D_fast": 281.0,
    "ToC3D_faster": 237.2,
    "stream_petr_eva_vit_l_1600": 1309.9,
    "ToC3D_fast_1600": 1051.9,
    "ToC3D_faster_1600": 878.5,
    "stream_petr_vit_b": 115.0,
    "ToC3D_vit_b_fast": 94.0,
    "ToC3D_vit_b_faster": 85.0,
}
# the paper's compression-payoff table: baseline, fast and faster per
# backbone and resolution (copied from bench.py:36-43)
SWEEP_FAMILIES = [
    ("ViT-L 800x320", ["stream_petr_eva_vit_l", "ToC3D_fast",
                       "ToC3D_faster"]),
    ("ViT-L 1600x800", ["stream_petr_eva_vit_l_1600", "ToC3D_fast_1600",
                        "ToC3D_faster_1600"]),
    ("ViT-B 800x320", ["stream_petr_vit_b", "ToC3D_vit_b_fast",
                       "ToC3D_vit_b_faster"]),
]
SCENE_LEN = 40      # frames per scene (bench.py:350)
CONTENTS = 4        # distinct image contents, cycled (bench.py:352)
VIEWS = 6


def make_frame(rng, b, n, h, w, prev_exists, pin: bool):
    """bench.py make_frame (:47-61) with a uint8 image: host tensors, in
    pinned memory when ``pin``."""
    eye = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    intr = eye.copy()
    intr[..., 0, 0] = intr[..., 1, 1] = 1.2e3
    img2lidar = eye + rng.randn(b, n, 4, 4).astype(np.float32) * 1e-3
    ego = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    frame = {
        "img": rng.randint(0, 256, (b, n, h, w, 3), dtype=np.uint8),
        "intrinsics": intr, "img2lidar": img2lidar,
        "timestamp": np.full((b,), 0.5, np.float32),
        "ego_pose": ego, "ego_pose_inv": ego.copy(),
        "prev_exists": np.full((b,), prev_exists, np.float32),
    }
    frame = {k: torch.from_numpy(v) for k, v in frame.items()}
    return {k: v.pin_memory() for k, v in frame.items()} if pin else frame


def make_train_batch(rng, b, n, h, w, g3=32, g2=32, prev_exists=1.0):
    """bench.py's synthetic training batch (make_train_batch, :64-84):
    random normalized views, a fixed rig, g3 3D and g2 2D boxes a lane,
    numpy."""
    eye = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    intr = eye.copy()
    intr[..., 0, 0] = intr[..., 1, 1] = 1.2e3
    boxes = rng.randn(b, g3, 9).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1.0
    b2d = np.sort(np.abs(rng.rand(b, n, g2, 2, 2)).astype(np.float32) * 300,
                  axis=-2).reshape(b, n, g2, 4)
    return {
        "img": rng.randn(b, n, h, w, 3).astype(np.float32),
        "intrinsics": intr,
        "img2lidar": eye + rng.randn(b, n, 4, 4).astype(np.float32) * 1e-3,
        "timestamp": np.full((b,), 0.5, np.float32),
        "ego_pose": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "ego_pose_inv": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "prev_exists": np.full((b,), prev_exists, np.float32),
        "gt_bboxes_3d": boxes,
        "gt_labels_3d": rng.randint(0, 10, (b, g3)),
        "gt_valid_3d": np.ones((b, g3), bool),
        "gt_bboxes_2d": b2d,
        "gt_labels_2d": rng.randint(0, 10, (b, n, g2)),
        "gt_centers_2d": rng.rand(b, n, g2, 2).astype(np.float32) * 300,
        "gt_valid_2d": np.ones((b, n, g2), bool),
    }


def schedule(i: int):
    """(content index, prev_exists) of frame i."""
    return i % CONTENTS, 0.0 if i % SCENE_LEN == 0 else 1.0


def fetch_start(det):
    """Queue the copy of one frame's boxes to the host (pinned) behind the
    frame; returns (host boxes, event) for ``fetch_wait``."""
    if not det.scores.is_cuda:
        return det, None
    host = type(det)(*(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       .copy_(t, non_blocking=True) for t in det))
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def fetch_wait(pending):
    """Wait for a fetch queued by ``fetch_start``: only for that frame, not
    for what was queued after it. Returns the boxes as numpy arrays."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return type(host)(*(t.numpy() for t in host))


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def parse_run(stdout: str):
    """The figures of one bench run from its output: {"fps", "ms",
    "peak_gib" (None off the card), "metric"}; None if the run printed no
    JSON line."""
    lines = stdout.strip().splitlines()
    if not lines or not lines[-1].startswith("{"):
        return None
    rec = json.loads(lines[-1])
    out = {"fps": rec["value"], "metric": rec["metric"], "ms": None,
           "peak_gib": None}
    for line in lines:
        if line.startswith("wall ") and line.endswith(" ms/frame"):
            out["ms"] = float(line.split()[1])
        elif line.startswith("peak device memory "):
            out["peak_gib"] = float(line.split()[3])
    return out


def sweep_table(results, families=SWEEP_FAMILIES):
    """The sweep's table (markdown) from {config: parse_run(...) or None}:
    per family, each config's ms/frame, frames/s, speedup over the family's
    first config (its ms over this one's) and peak GiB, beside the paper's
    A100 ms and its speedup."""
    rows = ["| Family | Config | ms/frame | frames/s | speedup vs baseline "
            "| peak GiB | paper's A100 ms (speedup) |",
            "|---|---|---|---|---|---|---|"]
    for fam, names in families:
        base = results.get(names[0])
        for name in names:
            rec = results.get(name)
            a100 = A100_PIPELINE_MS.get(name)
            a100_base = A100_PIPELINE_MS.get(names[0])
            paper = "-" if a100 is None else (
                f"{a100}" + ("" if name == names[0] or a100_base is None
                             else f" ({a100_base / a100:.3f}x)"))
            if rec is None:
                rows.append(f"| {fam} | {name} | FAILED | | | | {paper} |")
                continue
            speed = "1 (baseline)" if name == names[0] else (
                "-" if base is None else f"{base['ms'] / rec['ms']:.4f}x")
            peak = "-" if rec["peak_gib"] is None else f"{rec['peak_gib']}"
            rows.append(f"| {fam} | {name} | {rec['ms']} | {rec['fps']} | "
                        f"{speed} | {peak} | {paper} |")
    return "\n".join(rows)


def run_sweep(args) -> int:
    """Bench every config of SWEEP_FAMILIES in its own process (a fresh
    device memory pool and set of captures each) and print the table;
    non-zero if a config failed."""
    results = {}
    passthrough = ["--warmup", str(args.warmup), "--frames", str(args.frames),
                   "--batch", str(args.batch), "--device", args.device]
    passthrough += ["--int8"] * args.int8 + ["--eager"] * args.eager
    for _, names in SWEEP_FAMILIES:
        for name in names:
            cmd = [sys.executable, "-m", "toc3d_tpu_torch.bench", "--config",
                   name] + passthrough
            print(f"# bench {name} ...", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True)
            results[name] = parse_run(r.stdout) if r.returncode == 0 \
                else None
            if results[name] is None:
                print(f"# {name} FAILED (exit {r.returncode}):\n"
                      f"{r.stderr[-3000:]}", flush=True)
            else:
                print("\n".join(r.stdout.strip().splitlines()[-6:]),
                      flush=True)
    if torch.device(args.device).type == "cuda":
        print(nvidia_smi_line())
    print(sweep_table(results))
    return 0 if all(v is not None for v in results.values()) else 1


def train_label(args, cfg_label: str, batch: int, view_scan, attn_chunk):
    """bench.py's metric name of a training run (:156-161)."""
    vscan = view_scan if isinstance(view_scan, int) and \
        not isinstance(view_scan, bool) else bool(view_scan)
    return (f"{cfg_label} train step/s (batch {batch})"
            + (f"+vscan{vscan}" if vscan else "")
            + (f"+achunk{attn_chunk}" if attn_chunk else "")
            + (f"+queue{args.queue_length}" if args.queue_length > 1 else "")
            + ("+noremat" if args.no_remat else ""))


def bench_train(args, cuda: bool) -> int:
    """bench.py's bench_train (:86-178) on the port; prints its JSON record
    last. Non-zero if a loss or the gradient norm is not finite."""
    from .configs import get_config
    from .configs.presets import served_in_bf16
    from .models.detector import build_detector, frame_seed
    from .runtime.train import (auto_view_scan, batch_to_device,
                                draw_train_noise, init_train_state,
                                make_optimizer, make_train_step)
    from .tools.train import step_options

    smi = None
    if cuda:
        smi = nvidia_smi_line()
        print(smi, flush=True)
        from .ops.cuda import build
        build.build_all()
    cfg = get_config(args.config)
    label = args.config
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
        label += "+bf16"
    b, n, qlen = args.batch, VIEWS, args.queue_length
    h, w = cfg.pad_shape
    opts = step_options(args)
    if opts["view_scan"] is None:
        opts["view_scan"] = auto_view_scan(cfg) and opts["attn_chunk"] is None
    dev = torch.device(args.device)
    model = build_detector(cfg, device=dev, seed=0)
    tx = make_optimizer(model, total_iters=1000)
    state = init_train_state(model, tx, b)
    step = make_train_step(tx, remat=not args.no_remat,
                           multiframe=qlen > 1, **opts)
    rng = np.random.RandomState(0)
    if qlen > 1:
        # T consecutive frames a lane (petr3d.py:262-308)
        frames = [make_train_batch(rng, b, n, h, w) for _ in range(qlen)]
        host = {k: np.stack([f[k] for f in frames], axis=1)
                for k in frames[0]}
        batch, _ = batch_to_device(host, dev)
        steady = None
    else:
        batch, steady = batch_to_device(make_train_batch(rng, b, n, h, w),
                                        dev)
    gen = torch.Generator(device=dev)

    def run(i):
        nonlocal state
        gen.manual_seed(frame_seed(1, i))
        noise = [draw_train_noise(cfg, b, n, gen, dev, gt3=32)
                 for _ in range(max(qlen, 1))]
        state, m = step(state, batch, noise if qlen > 1 else noise[0],
                        steady=steady)
        return m

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):                     # settle
        m = run(i)
    m["total_loss"].item()
    iters = max(args.frames // 2, 50)
    trace = []
    t0 = time.perf_counter()
    for i in range(iters):
        m = run(3 + i)
        trace.append((m["total_loss"], m["grad_norm"]))
        if (i + 1) % 10 == 0:
            m["total_loss"].item()         # bound the queue
    losses = torch.stack([t[0] for t in trace]).double().cpu().numpy()
    gnorms = torch.stack([t[1] for t in trace]).double().cpu().numpy()
    dt = time.perf_counter() - t0
    skips = int(m["nonfinite_skips"])
    first5, last5 = losses[:5].mean(), losses[-5:].mean()
    finite = bool(np.isfinite(losses).all() and np.isfinite(gnorms).all())
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    where = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"{label} training on {where}: batch {b}, {n} views {w}x{h}, "
          f"view_scan {opts['view_scan']}, attn_chunk {opts['attn_chunk']}, "
          f"{iters} timed steps in {dt:.3f} s, "
          f"{b * iters / dt:.4f} samples/s"
          + ("" if peak is None else f", peak device memory {peak:.3f} GiB"))
    print(json.dumps({
        "metric": train_label(args, label, b, opts["view_scan"],
                              opts["attn_chunk"]),
        "value": round(iters / dt, 4),
        "unit": "steps/s",
        "vs_baseline": None,
        "steps": iters,
        "nonfinite_skips": skips,
        "loss_finite": finite,
        "loss_first5_mean": round(float(first5), 4),
        "loss_last5_mean": round(float(last5), 4),
        "loss_decreasing": bool(last5 < first5),
        "loss_trace_every5": [round(float(x), 3) for x in losses[::5]],
        "peak_gib": None if peak is None else round(peak, 3),
        "nvidia_smi": smi,
    }))
    return 0 if finite else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="ToC3D_faster_1600")
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving: backbone and decoder quant 'int8' "
                         "(dynamic per-row activation scales)")
    ap.add_argument("--int8-calib", type=int, default=0,
                    help="with --int8: static activation scales calibrated "
                         "on this many synthetic frames")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run the frame eagerly (infer_step) instead of as "
                         "captured CUDA graphs, for comparison")
    ap.add_argument("--sweep", action="store_true",
                    help="bench every config of SWEEP_FAMILIES, one process "
                         "each, and print the table")
    ap.add_argument("--train", action="store_true",
                    help="bench the full train step (steps/s) instead of "
                         "inference")
    ap.add_argument("--view-scan", choices=("auto", "on", "off"),
                    default="auto",
                    help="with --train: the backbone over chunks of views "
                         "(auto: on at 1600x800 unless --attn-chunk)")
    ap.add_argument("--view-chunk", type=int, default=0,
                    help="with --train: views a chunk (overrides "
                         "--view-scan; must divide 6)")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="with --train: the backbone's model-path attention "
                         "over chunks of this many windows")
    ap.add_argument("--queue-length", type=int, default=0,
                    help="with --train: train on this many consecutive "
                         "frames (losses from the last num_frame_losses)")
    ap.add_argument("--no-remat", action="store_true",
                    help="with --train: no checkpoint on the droppath "
                         "blocks and the decoder layers")
    args = ap.parse_args(argv)
    if args.int8_calib and not args.int8:
        ap.error("--int8-calib requires --int8")
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for the protocol "
              "check)", file=sys.stderr)
        return 2
    if args.sweep:
        if args.int8_calib:
            ap.error("--sweep takes no --int8-calib")
        return run_sweep(args)
    if args.train:
        if args.int8 or args.eager:
            ap.error("--train takes no --int8 or --eager")
        return bench_train(args, cuda)

    from .configs import get_config
    from .configs.presets import served_in_bf16
    from .models.detector import (build_detector, eager_infer_fn,
                                  frame_to_device, init_state, make_infer_fn)
    from .ops.int8_calib import attach_act_scales, calibrate_act_scales
    from .runtime.timer import StageTimer

    if cuda:
        print(nvidia_smi_line(), flush=True)
        from .ops.cuda import build
        build.build_all()
    cfg = get_config(args.config)
    label = args.config
    if cuda and cfg.compute_dtype != "bfloat16":
        # the kernels take bf16 activations (the `tiny` preset is f32)
        cfg = served_in_bf16(cfg)
        label += "+bf16"
        print(f"{args.config}: served in bf16 on the card (the kernels take "
              "bf16 activations)", flush=True)
    if args.int8:
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
        label += "+int8"
    h, w = cfg.pad_shape
    b, n = args.batch, VIEWS
    model = build_detector(cfg, device=args.device, seed=0)
    if args.int8_calib:
        crng = np.random.RandomState(7)
        cal = [frame_to_device(make_frame(crng, b, n, h, w, float(i > 0),
                                          False), args.device)
               for i in range(args.int8_calib)]
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(model, cal))
        label += f"+calib{args.int8_calib}"

    rng = np.random.RandomState(0)
    variants = [[make_frame(rng, b, n, h, w, pe, cuda)
                 for _ in range(CONTENTS)] for pe in (0.0, 1.0)]

    def frame_at(i):
        c, pe = schedule(i)
        return variants[int(pe)][c]

    timer = StageTimer(args.device)
    step = (eager_infer_fn if args.eager else make_infer_fn)(model, timer)
    if args.eager:
        label += "+eager"
    state = init_state(b, cfg, device=args.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(args.warmup):
        state, det = step(state, frame_at(i))
        if (i + 1) % 25 == 0:
            det.scores.cpu()        # bound the queue
    if args.warmup:
        det.scores.cpu()
    warm_s = time.perf_counter() - t0
    timer.reset()

    t0 = time.perf_counter()
    pending = None
    for i in range(args.frames):
        state, det = step(state, frame_at(i))
        fetch = fetch_start(det)
        if pending is not None:
            fetch_wait(pending)
        pending = fetch
    boxes = fetch_wait(pending)
    dt = time.perf_counter() - t0

    ok = bool(np.isfinite(boxes.scores).all() and np.isfinite(
        boxes.bboxes).all())
    where = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"{label} on {where}: batch {b}, {n} views {w}x{h}, warmup "
          f"{args.warmup} frames in {warm_s:.3f} s, {args.frames} timed "
          f"frames; last boxes finite {ok}")
    if cuda:
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"peak device memory {peak:.3f} GiB (warm-up and capture "
              "included)")
    print(f"wall {dt / args.frames * 1e3:.3f} ms/frame")
    for name, s in timer.summary().items():
        print(f"  {name:14s} {'device' if cuda else 'host'} ms/frame "
              f"mean {s['mean']:.3f} min {s['min']:.3f} max {s['max']:.3f} "
              f"(n {s['n']})")
    if not ok:
        print("bench: non-finite boxes", file=sys.stderr)
        return 1
    fps = args.frames * b / dt
    ref_fps = 1000.0 / A100_PIPELINE_MS.get(
        args.config, A100_PIPELINE_MS["ToC3D_faster_1600"])
    print(json.dumps({
        "metric": f"{label} {n}-view frames/sec/"
                  f"{'chip' if cuda else 'cpu'}",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / ref_fps, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
