"""Training entry point of the port (the twin of tools/train.py): streaming
single-frame training with the batch-lane scene sampler.

    python3 -m toc3d_tpu_torch.tools.train --config ToC3D_faster \\
        --ann data/nuscenes/nuscenes2d_temporal_infos_train.pkl \\
        --data-root data/nuscenes --iters 42195 --batch-size 2 \\
        [--load-from ckpt.pth] [--resume-from work_dirs/x/iter_100.pth] \\
        [--val-ann val.pkl --eval-interval N] [--device cuda]

Runner of the reference (tools/train.py, core/apis/mmdet_train.py):
AdamW with the backbone at lr x0.1, warmup then cosine, grad clip 35,
periodic checkpoints, and with --val-ann a streaming eval through the eval
CLI's path (toc3d_tpu_torch.tools.test) on the weights of the moment,
written to <work-dir>/eval_iter_N.pth. Samples are built on the host by
one prefetch thread; each step draws its noise from a generator seeded by
(--seed, step), so a resumed run draws the noise an uninterrupted one
would. The sampler and the augmentation draws restart from --seed on
--resume-from (as tools/train.py's do), so the batches differ.
Every --log-interval steps one JSON line goes to <work-dir>/train.log.json.

The default device is the card; without one it raises (``--device cpu``
runs on the CPU, for tests). On the card an f32 config (such as ``tiny``)
trains in bf16, as the eval CLI serves it: the kernels take bf16
activations.

``--distributed`` trains data-parallel (tools/train.py:121-134, 163-170,
211-216, 260-280), one process a device, under torchrun

    torchrun --nproc_per_node=N -m toc3d_tpu_torch.tools.train \
        --distributed --config ToC3D_faster --ann ... --batch-size 2

or with ``--dist-coordinator host:port --dist-num-processes N
--dist-process-id I`` on each process. On the card each rank trains on
``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo; nothing falls back
from one to the other). --batch-size is each rank's, the global batch is
batch x world; rank 0's weights and optimizer state are broadcast at the
start, the sampler gives each rank its lanes (num_replicas, rank), the
augmentation draws come from --seed + rank, every rank draws the global
batch's noise and keeps its lanes, and the gradients are averaged over the
ranks each step (runtime/train.make_train_step). The logged metrics are
the ranks' mean; only rank 0 writes the log, the checkpoints (the bank's
lanes gathered in rank order) and the final weights; --resume-from gives
each rank its lanes. The periodic eval runs distributed over the same
ranks.

``main(argv)`` returns a summary: the logged records, the checkpoints
written, the final weights' path and the eval results.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--work-dir", default="work_dirs/train")
    ap.add_argument("--iters", type=int, default=42195)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seq-split-num", type=int, default=2)
    ap.add_argument("--load-from", default=None,
                    help="reference checkpoint (.pth) to start from")
    ap.add_argument("--resume-from", default=None,
                    help="train state written by this CLI (iter_N.pth)")
    ap.add_argument("--checkpoint-interval", type=int, default=1758)
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-options", nargs="*", default=None,
                    help="dotted-key overrides, e.g. head.num_query=900")
    ap.add_argument("--src-h", type=int, default=900)
    ap.add_argument("--src-w", type=int, default=1600)
    ap.add_argument("--val-ann", default=None,
                    help="val info pkl for the periodic eval")
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="eval every N iters (0: only at the end)")
    ap.add_argument("--eval-limit", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true",
                    help="no torch.utils.checkpoint on the droppath blocks "
                         "and the decoder layers")
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel training over torchrun's "
                         "environment (NCCL on the card, gloo with "
                         "--device cpu)")
    ap.add_argument("--dist-coordinator", default=None,
                    help="host:port for a manual multi-process rendezvous")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises")
    return ap.parse_args(argv)


def train_aug(cfg, src_h: int, src_w: int):
    """The train-time resize / crop of a config's pad shape
    (tools/train.py:157-164): the presets' AUG_1600x800 or AUG_800x320;
    another pad shape resizes src_h x src_w sources around it."""
    from ..data.nuscenes import AUG_800x320, AUG_1600x800, AugConfig
    if cfg.pad_shape == (800, 1600):
        return AUG_1600x800
    if cfg.pad_shape == (320, 800):
        return AUG_800x320
    return AugConfig(final_dim=cfg.pad_shape, H=src_h, W=src_w,
                     resize_lim=(cfg.pad_shape[0] / src_h * 0.95,
                                 cfg.pad_shape[0] / src_h * 1.2))


def run_eval(args, model, step: int, device, distributed=False) -> dict:
    """The eval CLI (tools/test.py) on the model's weights of the moment:
    they are written as a checkpoint it loads, so every eval builds and
    captures its model anew. Distributed, rank 0 writes the checkpoint and
    every rank evaluates its chunk of scenes; the metrics are rank 0's
    (None elsewhere)."""
    import torch.distributed as dist

    from ..runtime.checkpoint import save_params
    from . import test
    path = os.path.join(args.work_dir, f"eval_iter_{step}.pth")
    if not distributed or dist.get_rank() == 0:
        save_params(model, path)
    if distributed:
        dist.barrier()
    argv = ["--config", args.config, "--ann", args.val_ann, "--checkpoint",
            path, "--work-dir", os.path.join(args.work_dir,
                                             f"eval_iter_{step}"),
            "--src-h", str(args.src_h), "--src-w", str(args.src_w),
            "--device", str(device)]
    if distributed:
        argv += ["--distributed"]
    if args.data_root:
        argv += ["--data-root", args.data_root]
    if args.eval_limit:
        argv += ["--limit", str(args.eval_limit)]
    if args.cfg_options:
        argv += ["--cfg-options", *args.cfg_options]
    out = test.main(argv)
    m = out["metrics"]
    if m is None:
        return None
    print(f"[eval @ iter {step}] " + json.dumps(
        {"mAP": round(m["mAP"], 4), "NDS": round(m["NDS"], 4)}))
    return m


def main(argv=None) -> dict:
    args = parse_args(argv)
    distributed = (args.distributed or args.dist_coordinator
                   or args.dist_num_processes
                   or args.dist_process_id is not None)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..configs import apply_overrides, get_config
    from ..configs.presets import served_in_bf16
    from ..data.loader import PrefetchIterator, build_train_sample
    from ..data.nuscenes import NuScenesInfos
    from ..data.sampler import (InfiniteGroupEachSampleInBatchSampler,
                                collate_batch)
    from ..models.detector import build_detector, frame_seed
    from ..runtime.checkpoint import (load_train_state, save_params,
                                      save_train_state)
    from ..parallel import mesh
    from ..runtime.train import (batch_to_device, draw_train_noise,
                                 init_train_state, make_lr_schedule,
                                 make_optimizer, make_train_step,
                                 noise_lanes)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card "
                           "(pass --device cpu for a CPU run)")
    group = None
    if distributed:
        device = mesh.init_distributed(args.dist_coordinator,
                                       args.dist_num_processes,
                                       args.dist_process_id, args.device)
        group = dist.group.WORLD
    world, rank = mesh.world_size(group), mesh.rank(group)
    lead = rank == 0
    global_batch = args.batch_size * world
    if distributed:
        print(f"process {rank}/{world} on {device}, global batch "
              f"{global_batch}")
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
        print(f"{args.config}: trained in bf16 on the card (the kernels "
              "take bf16 activations)")
    aug = train_aug(cfg, args.src_h, args.src_w)
    infos = NuScenesInfos(args.ann, seq_split_num=args.seq_split_num)

    sd = None
    if args.load_from:
        from ..convert import load_reference_checkpoint
        sd = load_reference_checkpoint(args.load_from)
    model = build_detector(cfg, device=device, state_dict=sd,
                           seed=args.seed)
    tx = make_optimizer(model, base_lr=args.lr, total_iters=args.iters)
    state = init_train_state(model, tx, args.batch_size)
    if group is not None:
        mesh.broadcast_train_state(model, state.opt_state, group)
    if args.resume_from:
        state = load_train_state(args.resume_from, state, tx, group)
        print(f"resumed from {args.resume_from} at step {state.step}")
    step_fn = make_train_step(tx, remat=not args.no_remat, group=group)

    sampler = InfiniteGroupEachSampleInBatchSampler(
        infos.flag, args.batch_size, num_replicas=world, rank=rank,
        seed=args.seed)
    rng = np.random.RandomState(args.seed + rank)

    def batches():
        for idxs in sampler:
            yield collate_batch([build_train_sample(
                infos, i, aug, rng, max_gt_3d=cfg.head.dn_max_gt,
                data_root=args.data_root) for i in idxs])

    if lead:
        os.makedirs(args.work_dir, exist_ok=True)
    log_json = os.path.join(args.work_dir, "train.log.json")
    lr_sched = make_lr_schedule(args.lr, total_iters=args.iters)
    gen = torch.Generator(device=device)
    records, checkpoints, evals = [], [], {}
    it = PrefetchIterator(batches(), depth=2)
    t0 = time.time()
    for step in range(state.step, args.iters):
        batch, steady = batch_to_device(next(it), device)
        views = batch["img"].shape[1]
        gen.manual_seed(frame_seed(args.seed, step))
        noise = draw_train_noise(cfg, global_batch, views, gen, device)
        if group is not None:
            noise = noise_lanes(noise, mesh.local_lanes(global_batch, group),
                                views)
        state, metrics = step_fn(state, batch, noise, steady=steady)
        if (step + 1) % args.log_interval == 0:
            if group is not None:
                names = sorted(metrics)
                mean = mesh.reduce_mean(torch.stack(
                    [metrics[k].float() for k in names]), group)
                metrics = dict(zip(names, mean.unbind()))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = (time.time() - t0) / args.log_interval
            t0 = time.time()
            print(f"iter {step + 1}/{args.iters} loss "
                  f"{metrics['total_loss']:.4f} grad_norm "
                  f"{metrics['grad_norm']:.2f} skips "
                  f"{int(metrics['nonfinite_skips'])} {dt:.2f}s/iter")
            rec = {"mode": "train", "iter": step + 1,
                   "lr": float(lr_sched(step + 1)), "time": round(dt, 4)}
            rec.update({k: round(v, 6) for k, v in metrics.items()})
            records.append(rec)
            if lead:
                with open(log_json, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if args.val_ann and args.eval_interval and \
                (step + 1) % args.eval_interval == 0:
            evals[step + 1] = run_eval(args, model, step + 1, device,
                                       distributed)
        if (step + 1) % args.checkpoint_interval == 0:
            path = save_train_state(state, tx, os.path.join(
                args.work_dir, f"iter_{step + 1}.pth"), group)
            checkpoints.append(path)
            if lead:
                print("saved", path)
    final = os.path.join(args.work_dir, "final.pth")
    if lead:
        save_params(model, final)
        print("saved", final)
    if args.val_ann:
        evals[args.iters] = run_eval(args, model, args.iters, device,
                                     distributed)
    if group is not None:
        dist.barrier()
        dist.destroy_process_group()
    return {"records": records, "checkpoints": checkpoints, "final": final,
            "evals": evals, "state": state}


if __name__ == "__main__":
    main()
