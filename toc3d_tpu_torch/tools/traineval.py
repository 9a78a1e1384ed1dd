"""Closed-loop proof of the port's training: a detector trained by the port
must detect (the twin of tools/traineval_closedloop.py).

    python3 -m toc3d_tpu_torch.tools.traineval --config tiny --iters 300 \\
        [--lr 4e-4] [--out TRAINEVAL_torch.json] [--device cuda]

Without nuScenes, learnable synthetic scenes (data/synthetic.py: images
rendered from the GT geometry) stand in for the data, and the internal
mAP / NDS must climb from ~0 through the whole pipeline: the batch-lane
sampler -> the train step (runtime/train.make_train_step) -> a checkpoint
saved mid-run and restored into a fresh state (save_train_state /
load_train_state; fresh weights from --seed + 123, so only the file can
carry the state across) -> the streaming eval (make_infer_fn) ->
submission annotations -> the internal evaluator (runtime/nusc_metrics).

The augmentation is deterministic, as JAX's (traineval_closedloop.py:131-137):
the train resize is pinned to the eval scale, with no flip and no crop
jitter. The batches are built in a child process (``BatchProcess``): the
step is bound by the host's launches, and a builder thread in this
process would hold the interpreter lock through the JPEG decode and the
augmentation. The sampler and the augmentation draws run on through the
resume (one child for the whole run), and each step draws its noise from
a generator seeded by (--seed, step), so a resumed run takes the steps an
unresumed one takes. The step runs without activation checkpointing
(make_train_step's remat): at the closed loop's small configs memory is
no object, and the recomputation only adds launches.

The default device is the card; without one it raises (``--device cpu``
runs on the CPU, for tests). On the card an f32 config (such as ``tiny``)
trains and evaluates in bf16 (configs/presets.served_in_bf16), as the
trainer CLI does there: kernels A, B and C run as autograd Functions in
the step, and the eval runs the captured frame (A, B, C and D). The
matcher is hungarian_match's default for the device: the auction kernel on
the card, the native LAP on the CPU.

Prints and (with --out) writes one JSON line: metric, value (the last
mAP), unit, vs_baseline, steps, resumed, map_trajectory [{iter, mAP, NDS,
mAP_present, NDS_present}], loss_first5_mean, loss_last5_mean, samples,
lr, wall_s, device and matcher. ``main(argv)`` returns that record and the
per-step losses.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--frames-per-scene", type=int, default=8)
    ap.add_argument("--objects", type=int, default=4)
    ap.add_argument("--src-h", type=int, default=180)
    ap.add_argument("--src-w", type=int, default=320)
    ap.add_argument("--eval-points", type=int, default=3,
                    help="number of mAP evaluations after the initial one")
    ap.add_argument("--out", default=None, help="write the JSON line here")
    ap.add_argument("--data-dir", default=None,
                    help="reuse / keep the synthetic dataset here")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises")
    return ap.parse_args(argv)


def train_batches(pkl, aug, batch_size: int, seed: int, max_gt_3d: int):
    """The loop's batches, in order: the batch-lane sampler over the infos
    at ``pkl``, each sample built with the augmentation draws of one
    RandomState(seed) (traineval_closedloop.py:147-156)."""
    import numpy as np
    from ..data.loader import build_train_sample
    from ..data.nuscenes import NuScenesInfos
    from ..data.sampler import (InfiniteGroupEachSampleInBatchSampler,
                                collate_batch)
    infos = NuScenesInfos(pkl, seq_split_num=1)
    sampler = InfiniteGroupEachSampleInBatchSampler(infos.flag, batch_size,
                                                    seed=seed)
    rng = np.random.RandomState(seed)
    for idxs in sampler:
        yield collate_batch([build_train_sample(infos, i, aug, rng,
                                                max_gt_3d=max_gt_3d)
                             for i in idxs])


def _batch_worker(out, args):
    for batch in train_batches(*args):
        out.put(batch)


class BatchProcess:
    """``train_batches(*args)`` in a spawned child process, ``depth``
    batches ahead; ``next()`` raises if the child has died. ``close()``,
    or leaving it as a context manager, stops it."""

    def __init__(self, *args, depth: int = 4):
        ctx = multiprocessing.get_context("spawn")
        self._q = ctx.Queue(maxsize=depth)
        self._p = ctx.Process(target=_batch_worker, args=(self._q, args),
                              daemon=True)
        self._p.start()

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=5)
            except queue.Empty:
                if not self._p.is_alive():
                    raise RuntimeError("the batch process exited with code "
                                       f"{self._p.exitcode}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._p.terminate()
        self._p.join()
        self._q.close()


def run_eval(infer, cfg, infos, aug, device) -> dict:
    """Streaming eval of every sample through ``infer`` (make_infer_fn of
    the eval model, kept across eval points), in order, prev_exists
    following the scene token (traineval_closedloop.py:34-83). Reports the
    devkit's 10-class mAP / NDS and the restriction to the classes the GT
    holds (mAP_present / NDS_present): the synthetic scenes hold 3 classes,
    so the 10-class mAP cannot pass 0.3."""
    from ..data.loader import build_eval_frame
    from ..models.detector import init_state
    from ..runtime import nusc_metrics
    from ..runtime.eval import sample_annos

    state = init_state(1, cfg, device=device)
    results = {}
    prev_scene = None
    for i in range(len(infos)):
        frame, meta = build_eval_frame(infos, i, aug)
        frame["prev_exists"][:] = float(meta["scene_token"] == prev_scene)
        prev_scene = meta["scene_token"]
        state, det = infer(state, frame)
        results[meta["token"]] = sample_annos(
            type(det)(*(t.cpu() for t in det)), meta)
    gt = nusc_metrics.build_gt_from_infos(infos.infos)
    m = nusc_metrics.evaluate(gt, results)
    present = tuple(sorted({b["detection_name"]
                            for boxes in gt.values() for b in boxes}))
    mp = nusc_metrics.evaluate(gt, results, class_names=present)
    return {"mAP": round(float(m["mAP"]), 4), "NDS": round(float(m["NDS"]), 4),
            "mAP_present": round(float(mp["mAP"]), 4),
            "NDS_present": round(float(mp["NDS"]), 4)}


def main(argv=None, resume: bool = True) -> dict:
    """Run the loop; returns {'record': the JSON line's dict, 'losses': the
    total loss of every step}. resume=False skips the mid-run save and
    restore (the tests' unresumed twin of a run)."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..configs import apply_overrides, get_config
    from ..configs.presets import served_in_bf16
    from ..core.assigner import resolve_impl
    from ..data.nuscenes import AugConfig, NuScenesInfos
    from ..data.synthetic import make_learnable_dataset
    from ..models.detector import build_detector, frame_seed, make_infer_fn
    from ..runtime.checkpoint import load_train_state, save_train_state
    from ..runtime.train import (batch_to_device, draw_train_noise,
                                 init_train_state, make_optimizer,
                                 make_train_step)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the closed loop runs on the card "
                           "(pass --device cpu for a CPU run)")
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
        print(f"[traineval] {args.config}: trained in bf16 on the card (the "
              "kernels take bf16 activations)", flush=True)

    data_dir = args.data_dir or tempfile.mkdtemp(prefix="traineval_")
    pkl = os.path.join(data_dir, "infos.pkl")
    if not os.path.exists(pkl):
        pkl = make_learnable_dataset(
            data_dir, n_scenes=args.scenes,
            frames_per_scene=args.frames_per_scene, n_cams=2,
            src_h=args.src_h, src_w=args.src_w, n_objects=args.objects,
            seed=args.seed)
    fh, fw = cfg.pad_shape
    s = max(fh / args.src_h, fw / args.src_w)
    aug = AugConfig(final_dim=cfg.pad_shape, H=args.src_h, W=args.src_w,
                    rand_flip=False, resize_lim=(s, s))
    infos_eval = NuScenesInfos(pkl)

    def optimizer(model):
        return make_optimizer(model, base_lr=args.lr, total_iters=args.iters,
                              warmup_iters=args.warmup)

    model = build_detector(cfg, device=device, seed=args.seed)
    tx = optimizer(model)
    state = init_train_state(model, tx, args.batch_size)
    step_fn = make_train_step(tx, remat=False)
    # the eval model: the training weights are loaded into it at each eval
    # point, and its infer function (on the card, the captured frame, which
    # recaptures on the new weights) is kept across eval points
    eval_model = build_detector(cfg, device=device,
                                state_dict=model.state_dict())
    infer = make_infer_fn(eval_model)

    def evaluate(it, state):
        eval_model.load_state_dict(state.model.state_dict())
        with torch.no_grad():
            point = dict(iter=it, **run_eval(infer, cfg, infos_eval, aug,
                                             device))
        print(f"[traineval] iter {it}: {point}", flush=True)
        return point

    traj = [evaluate(0, state)]
    eval_iters = sorted({args.iters * (i + 1) // args.eval_points
                         for i in range(args.eval_points)})
    resume_at = args.iters // 2
    ckpt = os.path.abspath(os.path.join(data_dir, "ckpt", "state.pth"))
    resumed = False
    pending, losses = [], []
    gen = torch.Generator(device=device)
    t0 = time.time()
    with BatchProcess(pkl, aug, args.batch_size, args.seed,
                      cfg.head.dn_max_gt) as batches:
        for step in range(args.iters):
            batch, steady = batch_to_device(next(batches), device)
            views = batch["img"].shape[1]
            gen.manual_seed(frame_seed(args.seed, step))
            noise = draw_train_noise(cfg, args.batch_size, views, gen,
                                     device)
            state, metrics = step_fn(state, batch, noise, steady=steady)
            pending.append(metrics["total_loss"])
            done = step + 1
            if resume and done == resume_at:
                # save, build a fresh state (fresh weights: nothing but the
                # file carries the state across), restore into it, go on
                save_train_state(state, tx, ckpt)
                fresh = build_detector(cfg, device=device,
                                       seed=args.seed + 123)
                tx = optimizer(fresh)
                state = load_train_state(ckpt, init_train_state(
                    fresh, tx, args.batch_size), tx)
                if state.step != resume_at:
                    raise RuntimeError(f"resumed at step {state.step}, "
                                       f"saved at {resume_at}")
                step_fn = make_train_step(tx, remat=False)
                resumed = True
                print(f"[traineval] checkpoint resume at iter {done} ok",
                      flush=True)
            if done % 25 == 0 or done in eval_iters or done == args.iters:
                losses += torch.stack(pending).float().cpu().tolist()
                pending = []
            if done % 25 == 0:
                print(f"[traineval] iter {done} loss {losses[-1]:.3f} "
                      f"({(time.time() - t0) / done:.3f} s/it)", flush=True)
            if done in eval_iters:
                traj.append(evaluate(done, state))

    save_train_state(state, tx, ckpt)      # the final state, for diagnosis
    wall = time.time() - t0
    record = {
        "metric": f"{args.config} closed-loop train->eval (synthetic scenes)",
        "value": traj[-1]["mAP"],
        "unit": "mAP",
        "vs_baseline": None,
        "steps": args.iters,
        "resumed": resumed,
        "map_trajectory": traj,
        "loss_first5_mean": round(float(np.mean(losses[:5])), 3),
        "loss_last5_mean": round(float(np.mean(losses[-5:])), 3),
        "samples": len(infos_eval),
        "lr": args.lr,
        "wall_s": round(wall, 1),
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "matcher": resolve_impl(device),
    }
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return {"record": record, "losses": losses}


if __name__ == "__main__":
    main()
