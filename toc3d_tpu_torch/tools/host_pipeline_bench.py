"""End-to-end host-pipeline throughput of the port (twin of
tools/host_pipeline_bench.py).

    python3 -m toc3d_tpu_torch.tools.host_pipeline_bench
        [--config ToC3D_faster] [--frames 230] [--warmup 200]
        [--distinct 24] [--host-probe 24] [--entropy photo|noise]
        [--keep DIR] [--device cuda]

Writes synthetic nuScenes-like infos over real full-resolution (900x1600)
JPEGs into a temporary directory (``--keep``: into DIR, kept), --distinct
image sets cycled over --warmup + --frames samples of one scene, then
measures three rates for one config:

  host   build_eval_frame alone (JPEG decode, resize, normalize): exact,
         fast (draft-mode decode) and fast with uint8 frames normalized on
         the device;
  infer  the frame on one preloaded host frame, the bench's protocol:
         seeded random weights, the captured make_infer_fn on the card,
         each frame's boxes fetched while the next is queued; f32 and uint8
         frames;
  e2e    PrefetchIterator(build_eval_frame) -> infer, the serving loop,
         fast (uint8) and exact.

The overlap efficiency is infer_wall / e2e_wall for the uint8 frames: 1.0
means the prefetch thread hides the host's preprocessing behind the
device. The last line is one JSON object with the JAX tool's keys (ms per
frame; value: the fast e2e rate in frames/s) plus the device's name.
``--device cpu`` runs the frame eagerly on the CPU (a check of the tool,
not a measurement of a device); the default device raises without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np


def make_fullres_dataset(tmpdir, n_frames, n_distinct, n_cams=6,
                         src_h=900, src_w=1600, entropy="photo"):
    """Infos pkl over n_frames samples of one scene cycling n_distinct
    image sets written as JPEGs (host_pipeline_bench.py:35-117): 'photo',
    smooth gradients with mild texture (~370 KB a 1600x900 q90 file, the
    conservative end of nuScenes camera JPEGs); 'noise', uniform noise
    (~1.27 MB a file, the decoder's worst case). Returns the pkl's path."""
    from PIL import Image

    rng = np.random.RandomState(0)
    img_dir = os.path.join(tmpdir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    if entropy == "noise":
        base = rng.randint(0, 255, (src_h, src_w, 3), np.uint8)
    else:
        yy, xx = np.mgrid[0:src_h, 0:src_w]
        base = np.stack([(xx / 8 + yy / 12) % 255, (xx / 6) % 255,
                         (yy / 9) % 255], -1)
        base = (base * 0.7 + rng.randn(src_h, src_w, 3) * 8)
        base = base.clip(0, 255).astype(np.uint8)
    paths = []
    for d in range(n_distinct):
        row = []
        for c in range(n_cams):
            p = os.path.join(img_dir, f"d{d}_c{c}.jpg")
            # shifted copies of one base: distinct files with a realistic
            # JPEG entropy, without n_distinct * n_cams draws
            Image.fromarray(np.roll(base, d * 31 + c * 7, axis=1)).save(
                p, quality=90)
            row.append(p)
        paths.append(row)

    intr = np.eye(3)
    intr[0, 0] = intr[1, 1] = 1200.0
    intr[0, 2], intr[1, 2] = src_w / 2, src_h / 2
    infos = []
    t = 1_600_000_000_000_000
    for f in range(n_frames):
        cams = {f"CAM{c}": {"data_path": p, "cam_intrinsic": intr,
                            "sensor2lidar_rotation": np.eye(3),
                            "sensor2lidar_translation": np.zeros(3),
                            "timestamp": t}
                for c, p in enumerate(paths[f % n_distinct])}
        infos.append({
            "cams": cams, "token": f"f{f}", "scene_token": "scene0",
            "timestamp": t, "prev": "" if f == 0 else f"f{f - 1}",
            "next": "", "frame_idx": f, "lidar_path": "none.bin",
            "sweeps": [] if f == 0 else [{"fake": 1}],
            "ego2global_rotation": [1, 0, 0, 0],
            "ego2global_translation": [0.1 * f, 0.0, 0.0],
            "lidar2ego_rotation": [1, 0, 0, 0],
            "lidar2ego_translation": [0.0, 0.0, 1.5],
            "gt_boxes": np.zeros((0, 7)), "gt_velocity": np.zeros((0, 2)),
            "gt_names": np.array([], dtype=object),
            "valid_flag": np.ones(0, bool),
            "num_lidar_pts": np.zeros(0, np.int64),
        })
        t += 500_000
    path = os.path.join(tmpdir, "infos.pkl")
    with open(path, "wb") as fh:
        pickle.dump({"infos": infos,
                     "metadata": {"version": "v1.0-test-synthetic"}}, fh)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="ToC3D_faster")
    ap.add_argument("--frames", type=int, default=230)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--distinct", type=int, default=24)
    ap.add_argument("--host-probe", type=int, default=24,
                    help="frames for the host-only timing pass")
    ap.add_argument("--entropy", choices=("photo", "noise"), default="photo",
                    help="synthetic JPEG content (photo ~ real nuScenes "
                         "file sizes; noise = worst-case)")
    ap.add_argument("--keep", default=None,
                    help="directory to generate into (kept); default tmp")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the three measurements; prints and returns the JSON record."""
    args = parse_args(argv)
    import torch

    from ..bench import fetch_start, fetch_wait
    from ..configs import get_config
    from ..configs.presets import served_in_bf16
    from ..data.loader import PrefetchIterator, build_eval_frame
    from ..data.nuscenes import NuScenesInfos
    from ..models.detector import build_detector, init_state, make_infer_fn
    from .test import eval_aug

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card "
                           "(pass --device cpu for a CPU run)")
    if cuda:
        from ..ops.cuda import build
        build.build_all()
    cfg = get_config(args.config)
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
    aug = eval_aug(cfg, 900, 1600)

    tmpdir = args.keep or tempfile.mkdtemp(prefix="hostpipe_")
    try:
        print(f"# generating {args.distinct} distinct 6-cam JPEG frames in "
              f"{tmpdir} ...", file=sys.stderr, flush=True)
        infos = NuScenesInfos(make_fullres_dataset(
            tmpdir, args.frames + args.warmup, args.distinct,
            entropy=args.entropy))
        n = len(infos)

        host = {}
        for mode, kw in (("exact", {}), ("fast", dict(fast_decode=True)),
                         ("fast_u8", dict(fast_decode=True,
                                          device_normalize=True))):
            build_eval_frame(infos, 0, aug, **kw)
            t0 = time.perf_counter()
            for i in range(args.host_probe):
                build_eval_frame(infos, i % n, aug, **kw)
            host[mode] = (time.perf_counter() - t0) / args.host_probe
            print(f"# host {mode}: {1000 * host[mode]:.1f} ms/frame",
                  file=sys.stderr, flush=True)

        model = build_detector(cfg, device=device, seed=0)
        infer = make_infer_fn(model)

        def infer_loop(frame):
            """The frame through infer on one preloaded host frame: each
            step uploads it again (the serving payload) and fetches the
            boxes with one frame of pipelining, the bench's protocol."""
            state = init_state(1, cfg, device=device)
            for i in range(args.warmup):
                state, det = infer(state, frame)
                if (i + 1) % 25 == 0:
                    det.scores.cpu()            # bound the queue
            if args.warmup:
                det.scores.cpu()
            t0 = time.perf_counter()
            pending = None
            for _ in range(args.frames):
                state, det = infer(state, frame)
                fetch = fetch_start(det)
                if pending is not None:
                    fetch_wait(pending)
                pending = fetch
            fetch_wait(pending)
            return (time.perf_counter() - t0) / args.frames

        frame, _ = build_eval_frame(infos, 0, aug)
        frame["prev_exists"][:] = 0.0
        infer_wall = infer_loop(frame)          # f32 payload
        frame_u8, _ = build_eval_frame(infos, 0, aug, fast_decode=True,
                                       device_normalize=True)
        frame_u8["prev_exists"][:] = 0.0
        infer_u8_wall = infer_loop(frame_u8)    # uint8 payload

        def run_e2e(fast, warm):
            """PrefetchIterator(build_eval_frame) -> infer over all n
            samples; the frames after the warm-up are timed. The first and
            the steady frame are separate captured programs (JAX's one
            jitted step takes both): both are captured on ``warm`` before
            the loop, since a capture inside it would stall the device
            while the queue fills, and the timed frames would then start
            from a full queue."""
            for prev in (0.0, 1.0):
                fr = dict(warm, prev_exists=np.full_like(warm["prev_exists"],
                                                         prev))
                infer(init_state(1, cfg, device=device), fr)
            state = init_state(1, cfg, device=device)

            def gen():
                for i in range(n):
                    yield build_eval_frame(infos, i, aug, fast_decode=fast,
                                           device_normalize=fast)

            prev_scene, pending = None, None
            t0 = time.perf_counter()
            for i, (fr, meta) in enumerate(PrefetchIterator(gen(), depth=4)):
                fr["prev_exists"][:] = float(meta["scene_token"]
                                             == prev_scene)
                prev_scene = meta["scene_token"]
                state, det = infer(state, fr)
                fetch = fetch_start(det)
                if pending is not None:
                    fetch_wait(pending)
                pending = fetch
                if i == args.warmup - 1:
                    fetch_wait(pending)
                    pending = None
                    t0 = time.perf_counter()
            fetch_wait(pending)
            return (time.perf_counter() - t0) / (n - args.warmup)

        e2e_fast = run_e2e(True, frame_u8)
        e2e_exact = run_e2e(False, frame)
    finally:
        if args.keep is None:
            shutil.rmtree(tmpdir, ignore_errors=True)

    out = {
        "metric": f"{args.config} host-pipeline e2e",
        "value": round(1.0 / e2e_fast, 3),
        "unit": "frames/s",
        "vs_baseline": None,
        "entropy": args.entropy,
        "host_exact_ms": round(1000 * host["exact"], 1),
        "host_fast_ms": round(1000 * host["fast"], 1),
        "host_fast_u8_ms": round(1000 * host["fast_u8"], 1),
        "infer_ms": round(1000 * infer_wall, 1),
        "infer_u8_ms": round(1000 * infer_u8_wall, 1),
        "e2e_exact_ms": round(1000 * e2e_exact, 1),
        "e2e_fast_ms": round(1000 * e2e_fast, 1),
        "overlap_eff_fast": round(infer_u8_wall / e2e_fast, 3),
        "host_bound": bool(e2e_fast > 1.1 * infer_u8_wall),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
