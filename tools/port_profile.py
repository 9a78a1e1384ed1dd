"""Device-time breakdown of the PyTorch port's main path on one GPU, eager
and captured.

    python3 tools/port_profile.py [--config ToC3D_faster_1600] [--frames 2]
                                  [--warmup 3] [--int8 [--int8-calib N]]

Builds the preset ``--config`` (any name configs/presets.get_config takes)
with seeded random weights (6 views at the preset's pad shape, batch 1,
uint8 frames built on the host in pinned memory; with --int8 the
backbone and decoder quant 'int8', dynamic, or static with scales
calibrated on N synthetic frames as bench.py --int8 --int8-calib N does).
Then, in one process, for each of the two ways to run a frame: eager
(``eager_infer_fn``, i.e. ``infer_step``) and captured (``make_infer_fn``,
the frame as CUDA graphs), streams ``warmup`` frames, then records
``frames`` steady frames under torch.profiler and prints: the wall time per
frame, the summed device time of the CUDA kernels per frame (copies and
fills not counted), the device idle share (1 - kernel time / wall time),
the device time of the port's own kernels grouped by family and the top
kernels; then the time per frame between the first and last kernel of each
program from CUDA events (runtime/timer.py), which stands in for the
kernel sum should the profiler see no kernel inside a replay. First line:
the card's nvidia-smi name and power limit. Needs a CUDA card; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name substring -> family, first match wins: kernel G
# (gemm90::gemm_sm90_kernel) carries every bf16 matmul of B and C and the
# patch embedding A's product, kernel G8 (gemm90::gemm_s8_sm90_kernel) every
# int8 matmul of B8 and C8, kernel H8 (h8::int8_linear_kernel) the head's
# int8 linears with their row quantization; gemm.cuh's mma.sync tile
# (gemm::gemm_kernel) runs on no main path, so its bucket should stay empty;
# A's other launch is its im2col copy
FAMILIES = (("int8_linear_kernel", "int8 linear wgmma H8 (quantizing)"),
            ("gemm_s8_sm90_kernel", "GEMM s8 wgmma G8 (B8, C8)"),
            ("gemm_sm90_kernel", "GEMM bf16 wgmma (A, B, C)"),
            ("gemm_kernel", "GEMM mma.sync (gemm_s8, no main path)"),
            ("patch_im2col_kernel", "patch im2col (A)"),
            ("rowquant_kernel", "row quantization (B8, C8)"),
            ("window_attention_kernel", "window attention (B, C)"),
            ("layernorm_kernel", "LayerNorm (B, C, B8, C8)"),
            ("gather_merge_kernel", "gather/merge (C)"),
            ("scatter_update_kernel", "scatter/update (C)"),
            ("flash_partial_kernel", "flash attention (D), partial"),
            ("flash_combine_kernel", "flash attention (D), combine"))


def profile(infer, state, frames, warm, timer=None):
    """Stream ``warm`` frames, then profile ``frames``; returns (state, wall
    ms per frame, {kernel name: device ms summed})."""
    import torch
    for f in warm:
        state, _ = infer(state, f)
    torch.cuda.synchronize()
    if timer is not None:
        timer.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in frames:
            state, _ = infer(state, f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    per_kernel = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and "Memcpy" not in ev.name and "Memset" not in ev.name:
            per_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
    return state, wall, per_kernel


def report(label, wall, per_kernel, n, top):
    total = sum(per_kernel.values())
    print(f"{label}: wall {wall:.3f} ms/frame; device kernel time "
          f"{total / n:.3f} ms/frame; device idle share "
          f"{max(0.0, 1 - total / n / wall):.3f}", flush=True)
    if not total:
        return
    fam = defaultdict(float)
    for name, ms in per_kernel.items():
        key = next((lab for pat, lab in FAMILIES if pat in name),
                   "other (PyTorch glue)")
        fam[key] += ms
    for key, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"  {key:30s} {ms / n:9.3f} ms/frame  {ms / total:6.1%}")
    print("  top kernels (ms/frame):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms / n:9.3f}  {name[:110]}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ToC3D_faster_1600")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-calib", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector,
                                                 eager_infer_fn, init_state,
                                                 make_infer_fn,
                                                 synthetic_frame)
    from toc3d_tpu_torch.ops.cuda import build
    from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                                calibrate_act_scales)
    from toc3d_tpu_torch.runtime.timer import StageTimer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.build_all()
    cfg = get_config(args.config)
    h, w = cfg.pad_shape
    if args.int8:
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    model = build_detector(cfg, device="cuda", seed=0)
    g = torch.Generator().manual_seed(2)
    if args.int8_calib:
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(
                model, [{k: v.cuda() for k, v in
                         synthetic_frame(g, t, height=h, width=w,
                                         device="cpu").items()}
                        for t in range(args.int8_calib)]))
    frames = [{k: v.pin_memory() for k, v in
               synthetic_frame(g, t, height=h, width=w, device="cpu").items()}
              for t in range(args.warmup + args.frames)]
    warm, timed = frames[:args.warmup], frames[args.warmup:]
    mode = args.config + " " + (
        "bf16" if not args.int8 else "int8 static" if args.int8_calib
        else "int8 dynamic")
    n = args.frames
    for name, make in (("eager", eager_infer_fn),
                       ("captured", make_infer_fn)):
        timer = StageTimer("cuda")
        infer = make(model, timer)
        with torch.no_grad():
            _, wall, kern = profile(infer, init_state(1, cfg, device="cuda"),
                                    timed, warm, timer)
        report(f"{mode} {name}", wall, kern, n, args.top)
        spans = timer.summary()
        dev_ms = spans["backbone+neck"]["mean"] + spans["head+decode"]["mean"]
        print(f"{mode} {name}, CUDA events: backbone+neck "
              f"{spans['backbone+neck']['mean']:.3f} + head+decode "
              f"{spans['head+decode']['mean']:.3f} = {dev_ms:.3f} ms/frame "
              f"between the programs' first and last kernels (inputs "
              f"{spans['inputs']['mean']:.3f}); idle share by events "
              f"{max(0.0, 1 - dev_ms / wall):.3f}"
              + ("" if kern else "; the profiler saw no kernel"), flush=True)
        del infer
    return 0


if __name__ == "__main__":
    sys.exit(main())
