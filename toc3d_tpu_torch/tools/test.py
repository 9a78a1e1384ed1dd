"""Streaming evaluation entry point of the port (the twin of tools/test.py):
scene-ordered inference over an info pkl, results_nusc.json, mAP / NDS.

    python3 -m toc3d_tpu_torch.tools.test --config ToC3D_faster_1600 \\
        --ann data/nuscenes/nuscenes2d_temporal_infos_val.pkl \\
        --data-root data/nuscenes --checkpoint ckpt.pth \\
        --work-dir work_dirs/eval [--speed-test] [--fast-decode] \\
        [--device cuda]

Frames are built on the host by one prefetch thread (data/loader.py) and
streamed through ``make_infer_fn``: on the card the captured frame
(runtime/graphs.CapturedInfer), on the CPU (``--device cpu``, for tests)
``infer_step`` eagerly. Frame t-1's boxes are fetched to the host while
frame t is queued, as tools/test.py:151-180 does. Without a card the
default device raises; nothing falls back to the CPU. An f32 config (such
as ``tiny``) is served in bf16 on the card, as the bench serves it.

``--checkpoint x.pth`` loads a reference checkpoint
(convert.load_reference_checkpoint); an orbax directory is the JAX
package's own format and raises. Without a checkpoint the weights are
random, seeded 0.

``--distributed`` (or the ``--dist-*`` flags) evaluates on several
processes, one device each (tools/test.py:116-128): under torchrun

    torchrun --nproc_per_node=N -m toc3d_tpu_torch.tools.test \
        --distributed --config ... --ann ...

or with ``--dist-coordinator host:port --dist-num-processes N
--dist-process-id I`` on each process. On the card each rank runs on
``cuda:LOCAL_RANK`` over NCCL; ``--device cpu`` joins over gloo; nothing
falls back from one to the other. Each rank streams one contiguous chunk of
whole scenes, the results are gathered (runtime/eval.
gather_results_multihost), and only rank 0 writes the submission and scores
it. Called with a process group already joined (the trainer's periodic
eval), it evaluates over that group.

``main(argv)`` returns a summary for callers in the same process: the
submission's path, its metrics, the host's ms to build each frame, the
loop's wall clock after each frame and, with ``--speed-test``, each
frame's per-stage device ms (runtime/timer.py's stamp log; printed as
an indented 'A/B' tree of the nested spans).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--work-dir", default="work_dirs/eval")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--speed-test", action="store_true",
                    help="activate the warmup-200 timing protocol "
                         "(test_time_print equivalent) and the per-stage "
                         "device timer")
    ap.add_argument("--fast-decode", action="store_true",
                    help="production serving pipeline: reduced-scale JPEG "
                         "decode + uint8 device-side normalization "
                         "(4x smaller upload; pixel values differ slightly "
                         "from the parity-exact path)")
    ap.add_argument("--token-vis", type=int, default=0, metavar="N",
                    help="write kept/dropped token PNGs for the first N "
                         "samples (token_vis_ToC3D config equivalent)")
    ap.add_argument("--vis-out", default="token_vis")
    ap.add_argument("--src-h", type=int, default=900)
    ap.add_argument("--src-w", type=int, default=1600)
    ap.add_argument("--cfg-options", nargs="*", default=None,
                    help="dotted-key overrides, e.g. head.num_query=900")
    ap.add_argument("--ref-parity", action="store_true",
                    help="reproduce the reference's eval conventions exactly:"
                         " gumbel-STOCHASTIC token mask (the reference keeps"
                         " F.gumbel_softmax noisy at eval,"
                         " toc3d_utils.py:146-147) seeded by --ref-parity-seed")
    ap.add_argument("--ref-parity-seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process eval over torchrun's environment "
                         "(NCCL on the card, gloo with --device cpu)")
    ap.add_argument("--dist-coordinator", default=None)
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises")
    return ap.parse_args(argv)


def eval_aug(cfg, src_h: int, src_w: int):
    """The eval resize / crop of a config's pad shape (tools/test.py:
    92-100): the presets' AUG_1600x800 or AUG_800x320; another pad shape
    (the tiny test configs) resizes src_h x src_w sources straight to it."""
    from ..data.nuscenes import AUG_800x320, AUG_1600x800, AugConfig
    if cfg.pad_shape == (800, 1600):
        return AUG_1600x800
    if cfg.pad_shape == (320, 800):
        return AUG_800x320
    return AugConfig(final_dim=cfg.pad_shape, H=src_h, W=src_w,
                     rand_flip=False)


def main(argv=None) -> dict:
    args = parse_args(argv)
    distributed = (args.distributed or args.dist_coordinator
                   or args.dist_num_processes
                   or args.dist_process_id is not None)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..bench import fetch_start, fetch_wait
    from ..configs import apply_overrides, get_config
    from ..configs.presets import served_in_bf16
    from ..data.loader import PrefetchIterator, build_eval_frame
    from ..data.nuscenes import NuScenesInfos
    from ..models.detector import (build_detector, infer_step_with_aux,
                                   init_state, make_infer_fn)
    from ..runtime import nusc_metrics
    from ..runtime.eval import (evaluate_submission,
                                gather_results_multihost, sample_annos,
                                write_submission)
    from ..runtime.timer import LOG_ENTRIES, StageTimer, tree

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the eval runs on the card "
                           "(pass --device cpu for a CPU run)")
    world, rank, owned = 1, 0, False
    if distributed:
        if not dist.is_initialized():
            from ..parallel.mesh import init_distributed
            device = init_distributed(args.dist_coordinator,
                                      args.dist_num_processes,
                                      args.dist_process_id, args.device)
            owned = True
        world, rank = dist.get_world_size(), dist.get_rank()
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    if args.ref_parity and cfg.is_toc3d:
        cfg = replace(cfg, backbone=replace(cfg.backbone,
                                            eval_mask="gumbel"))
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
        print(f"{args.config}: served in bf16 on the card (the kernels "
              "take bf16 activations)")
    aug = eval_aug(cfg, args.src_h, args.src_w)
    infos = NuScenesInfos(args.ann)
    n = min(len(infos), args.limit) if args.limit else len(infos)

    if args.checkpoint and os.path.isdir(args.checkpoint):
        raise ValueError(
            f"{args.checkpoint} is a directory: orbax checkpoints are the "
            "JAX package's own format; give a reference .pth")
    if args.checkpoint:
        from ..convert import load_reference_checkpoint
        model = build_detector(cfg, device=device, state_dict=(
            load_reference_checkpoint(args.checkpoint)))
    else:
        print("WARNING: no checkpoint — evaluating random weights")
        model = build_detector(cfg, device=device, seed=0)

    # 14 stamps a ToC3D frame (7 spans), twice that as room
    timer = StageTimer(device, max(LOG_ENTRIES, 32 * n)) \
        if args.speed_test else None
    infer = make_infer_fn(model, timer, mask_seed=args.ref_parity_seed)

    build_ms = []

    # contiguous chunks of whole scenes per rank (streaming needs whole
    # scenes; contiguity keeps the gathered results in the global order)
    sample_range = range(n)
    if distributed:
        scene_of = [infos.infos[i]["scene_token"] for i in range(n)]
        starts = [0] + [i for i in range(1, n)
                        if scene_of[i] != scene_of[i - 1]]
        per = -(-len(starts) // world)
        lo = starts[rank * per] if rank * per < len(starts) else n
        hi = starts[(rank + 1) * per] if (rank + 1) * per < len(starts) \
            else n
        sample_range = range(lo, hi)
        print(f"process {rank}/{world}: samples [{lo}, {hi})")

    def frames():
        for i in sample_range:
            t0 = time.perf_counter()
            out = build_eval_frame(infos, i, aug, args.data_root,
                                   fast_decode=args.fast_decode,
                                   device_normalize=args.fast_decode)
            build_ms.append((time.perf_counter() - t0) * 1e3)
            yield out

    results = {}
    state = init_state(1, cfg, device=device)
    prev_scene = None
    t_total, timed = 0.0, 0
    done_at = []
    pending = None   # fetch frame t-1 after dispatching frame t (pipelined)
    t_start = time.perf_counter()
    for i, (frame, meta) in enumerate(PrefetchIterator(frames())):
        pe = 1.0 if meta["scene_token"] == prev_scene else 0.0
        prev_scene = meta["scene_token"]
        frame["prev_exists"][:] = pe
        t0 = time.perf_counter()
        if i < args.token_vis and cfg.is_toc3d:
            from ..runtime.token_vis import token_selection_vis
            state, det, aux = infer_step_with_aux(model, state, frame)
            token_selection_vis(
                np.asarray(frame["img"][0]),
                [m.float().cpu().numpy() for m in aux["token_masks"]],
                os.path.join(args.vis_out, str(i)),
                patch_size=cfg.backbone.patch_size)
        else:
            state, det = infer(state, frame)
        fetch = fetch_start(det)
        if pending is not None:
            results[pending[1]["token"]] = sample_annos(
                fetch_wait(pending[0]), pending[1])
        pending = (fetch, meta)
        dt = time.perf_counter() - t0
        done_at.append(time.perf_counter() - t_start)
        if i >= 200:                       # reference warmup protocol
            t_total += dt
            timed += 1
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{n} samples")
    if pending is not None:
        results[pending[1]["token"]] = sample_annos(fetch_wait(pending[0]),
                                                    pending[1])

    stage_ms = timer.samples() if timer is not None else {}
    if distributed:
        results = gather_results_multihost(results)
        if owned:
            dist.destroy_process_group()
        if rank != 0:
            return {"path": None, "results": results, "metrics": None,
                    "build_ms": build_ms, "done_at": done_at,
                    "stage_ms": stage_ms}
    path = write_submission(results, args.work_dir)
    print("wrote", path)
    if timed:
        print(f"speed: {timed / t_total:.3f} frames/s "
              f"({1000 * t_total / timed:.1f} ms/frame, warmup 200)")
    if stage_ms:
        print(f"stages, {'device' if cuda else 'host'} ms a span:")
        for line in tree(stage_ms):
            print("  " + line)

    try:
        metrics = evaluate_submission(path, args.data_root or ".",
                                      version=infos.version)
        print(json.dumps(metrics))
    except ImportError:
        gt = nusc_metrics.build_gt_from_infos(infos.infos[:n])
        metrics = nusc_metrics.evaluate(gt, results)
        metrics["evaluator"] = "internal"
        print(json.dumps({"mAP": metrics["mAP"], "NDS": metrics["NDS"],
                          "evaluator": "internal"}))
    return {"path": path, "results": results, "metrics": metrics,
            "build_ms": build_ms, "done_at": done_at, "stage_ms": stage_ms}


if __name__ == "__main__":
    main()
