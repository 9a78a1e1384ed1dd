"""Device-time breakdown of the PyTorch port's main path on one GPU.

    python3 tools/port_profile.py [--frames 2] [--warmup 3] [--int8
                                  [--int8-calib N]]

Builds ToC3D_faster_1600 with seeded random weights (6 views, 1600x800,
batch 1, uint8 frames; with --int8 the backbone and decoder quant 'int8',
dynamic, or static with scales calibrated on N synthetic frames as
bench.py --int8 --int8-calib N does), streams ``warmup`` frames, then
records ``frames``
steady frames under torch.profiler and prints: the card's nvidia-smi name
and power limit, the wall time per frame, the summed device time per CUDA
kernel (top entries), the device time of the port's own kernels grouped by
family, and the device idle share (1 - kernel time / wall time). Needs a CUDA
card; exits non-zero without one.
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
# int8 matmul of B8 and C8, gemm.cuh's mma.sync tile (gemm::gemm_kernel) the
# head's int8 linears; A's other launch is its im2col copy
FAMILIES = (("gemm_s8_sm90_kernel", "GEMM s8 wgmma G8 (B8, C8)"),
            ("gemm_sm90_kernel", "GEMM bf16 wgmma (A, B, C)"),
            ("gemm_kernel", "GEMM mma.sync (H8)"),
            ("patch_im2col_kernel", "patch im2col (A)"),
            ("rowquant_kernel", "row quantization (B8, C8, H8)"),
            ("window_attention_kernel", "window attention (B, C)"),
            ("layernorm_kernel", "LayerNorm (B, C, B8, C8)"),
            ("gather_merge_kernel", "gather/merge (C)"),
            ("scatter_update_kernel", "scatter/update (C)"),
            ("flash_partial_kernel", "flash attention (D), partial"),
            ("flash_combine_kernel", "flash attention (D), combine"))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
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
    from toc3d_tpu_torch.models.detector import (build_detector, init_state,
                                                 make_infer_fn,
                                                 synthetic_frame)
    from toc3d_tpu_torch.ops.cuda import build
    from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                                calibrate_act_scales)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.build_all()
    cfg = get_config("ToC3D_faster_1600")
    if args.int8:
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    model = build_detector(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    if args.int8_calib:
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(
                model, [synthetic_frame(g, t)
                        for t in range(args.int8_calib)]))
    infer = make_infer_fn(model)
    state = init_state(1, model.cfg, device="cuda")
    with torch.no_grad():
        for t in range(args.warmup):
            state, _ = infer(state, synthetic_frame(g, t))
        frames = [synthetic_frame(g, args.warmup + t)
                  for t in range(args.frames)]
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for f in frames:
                state, det = infer(state, f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    per_kernel = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
    total = sum(per_kernel.values())
    n = args.frames
    mode = ("bf16" if not args.int8 else "int8 static" if args.int8_calib
            else "int8 dynamic")
    print(f"{mode}: wall {wall / n:.3f} ms/frame; device kernel time "
          f"{total / n:.3f} ms/frame; device idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    fam = defaultdict(float)
    for name, ms in per_kernel.items():
        key = next((label for pat, label in FAMILIES if pat in name),
                   "other (PyTorch glue)")
        fam[key] += ms
    for key, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"  {key:30s} {ms / n:9.3f} ms/frame  {ms / total:6.1%}")
    print("top kernels (ms/frame):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[
            :args.top]:
        print(f"  {ms / n:9.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
