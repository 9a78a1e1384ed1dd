"""Multi-process dry run of the port (the twin of
__graft_entry__.dryrun_multichip): one real data-parallel training step of
the ``tiny`` preset over n ranks (grid mask, ToC3D backbone with token
selection, the 2D head, DN, the Hungarian losses, the averaged gradients,
AdamW), then one view-sharded streaming inference step on the trained
weights (parallel/infer_spmd.py).

    python3 -m toc3d_tpu_torch.tools.dryrun --device cpu -n 2   # gloo
    python3 -m toc3d_tpu_torch.tools.dryrun                     # NCCL, 1

On the CPU the n ranks are spawned processes over gloo, one lane each; on
the card each rank takes a card of its own over NCCL, so n is at most the
number of cards (one on a one-card machine). The ranks meet through a file
in a temporary directory. Each rank prints one line; the script exits with
the first failing rank's code.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def synthetic_batch(g, b: int, n: int, h: int, w: int, g3: int = 4,
                    g2: int = 4, device="cpu"):
    """A training batch of b lanes x n views drawn from generator ``g``:
    random normalized images, a fixed pinhole rig, g3 3D and g2 2D boxes a
    lane (__graft_entry__.dryrun_multichip's batch)."""
    import torch
    eye = torch.eye(4).repeat(b, n, 1, 1)
    intr = eye.clone()
    intr[..., 0, 0] = intr[..., 1, 1] = 1.2e3
    boxes = torch.randn(b, g3, 9, generator=g)
    boxes[..., 3:6] = boxes[..., 3:6].abs() + 1.0
    b2d = (torch.rand(b, n, g2, 2, 2, generator=g) * 30).sort(dim=-2)[0]
    batch = {
        "img": torch.randn(b, n, h, w, 3, generator=g),
        "intrinsics": intr, "img2lidar": eye,
        "timestamp": torch.full((b,), 0.5),
        "ego_pose": torch.eye(4).repeat(b, 1, 1),
        "ego_pose_inv": torch.eye(4).repeat(b, 1, 1),
        "prev_exists": torch.zeros(b),
        "gt_bboxes_3d": boxes,
        "gt_labels_3d": torch.randint(0, 10, (b, g3), generator=g),
        "gt_valid_3d": torch.ones(b, g3, dtype=torch.bool),
        "gt_bboxes_2d": b2d.reshape(b, n, g2, 4),
        "gt_labels_2d": torch.randint(0, 10, (b, n, g2), generator=g),
        "gt_centers_2d": torch.rand(b, n, g2, 2, generator=g) * 30,
        "gt_valid_2d": torch.ones(b, n, g2, dtype=torch.bool),
    }
    return {k: v.to(device) for k, v in batch.items()}


def run_rank(rank: int, world: int, store: str, device: str) -> str:
    """One rank of the dry run; returns its report line."""
    import torch
    from ..configs import get_config
    from ..models.detector import (build_detector, init_state,
                                   synthetic_frame)
    from ..parallel import mesh
    from ..parallel.infer_spmd import make_spmd_infer_fn, view_mesh
    from ..runtime import train as tr

    if device == "cpu":
        torch.set_num_threads(1)
    dev = mesh.init_distributed(f"file://{store}", world, rank, device)
    try:
        cfg = get_config("tiny")
        if dev.type == "cuda":
            from ..configs.presets import served_in_bf16
            cfg = served_in_bf16(cfg)
        views, h, w = 2, *cfg.pad_shape
        model = build_detector(cfg, device=dev, seed=0)
        tx = tr.make_optimizer(model, total_iters=100)
        state = tr.init_train_state(model, tx, 1)
        mesh.broadcast_train_state(model, state.opt_state)
        g = torch.Generator().manual_seed(0)
        batch = mesh.shard_batch(synthetic_batch(g, world, views, h, w,
                                                 device=dev))
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = tr.noise_lanes(tr.draw_train_noise(cfg, world, views, gen,
                                                   dev),
                               mesh.local_lanes(world), views)
        step = tr.make_train_step(tx, group=torch.distributed.group.WORLD)
        state, metrics = step(state, batch, noise, steady=False)
        total = float(mesh.reduce_mean(metrics["total_loss"]))
        if not torch.isfinite(torch.tensor(total)):
            raise RuntimeError(f"non-finite loss {total}")

        vmesh = view_mesh(num_views=views)
        served = "outside the view mesh"
        if vmesh.member:
            infer = make_spmd_infer_fn(model, vmesh)
            frame = synthetic_frame(
                torch.Generator(device=dev).manual_seed(2), 0, 1, views, h,
                w, device=dev)
            _, det = infer(init_state(1, cfg, device=dev), frame)
            if not bool(torch.isfinite(det.scores).all()):
                raise RuntimeError("non-finite scores")
            served = f"view-sharded inference ok over {vmesh.view} rank(s)"
        return (f"dryrun_multichip({world}) rank {rank} ok on {dev}: "
                f"total_loss={total:.4f}, step={state.step}, {served}")
    finally:
        torch.distributed.destroy_process_group()


def _child(rank, world, store, device, queue):
    try:
        queue.put((rank, 0, run_rank(rank, world, store, device)))
    except BaseException as e:      # reported by the parent
        queue.put((rank, 1, f"rank {rank} failed: {e!r}"))
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--num-processes", type=int, default=None,
                    help="ranks (default: 2 on the CPU, every card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, a card a rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for gloo)")
    n = args.num_processes or (torch.cuda.device_count() if cuda else 2)
    if cuda and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} cards, "
                         f"{torch.cuda.device_count()} visible")
    if cuda:
        from ..ops.cuda.build import build_all
        build_all()         # once, before the ranks start
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child,
                             args=(r, n, store, args.device, queue))
                 for r in range(n)]
        for p in procs:
            p.start()
        reports = sorted(queue.get(timeout=900) for _ in procs)
        for p in procs:
            p.join(60)
    for _, _, line in reports:
        print(line)
    return max([rc for _, rc, _ in reports]
               + [p.exitcode or 0 for p in procs])


if __name__ == "__main__":
    sys.exit(main())
