"""Learnable synthetic nuScenes-format scenes (no real data required);
a copy of toc3d_tpu/data/synthetic.py (make_learnable_dataset :116).

Renders multi-view frames where the IMAGES ARE CORRELATED WITH THE GT:
each 3D object projects to a solid class-colored rectangle whose position
and apparent size follow the camera geometry. A detector trained on these
frames can therefore genuinely learn detection (not just memorize noise),
which closes the train -> eval loop on machines without nuScenes: train
until the internal mAP/NDS climbs, through the same info-pkl, sampler,
streaming-eval and submission machinery the real dataset uses.

The reference proves training correctness with real-data val metrics at
the end of its logs (training_logs/ToC3D_fast.log); this module is the
data-free analogue driving the identical pipeline surface
(tools/train.py --val-ann + runtime/nusc_metrics).

Conventions match data/convert.py output: gt_boxes gravity-center
(x, y, z, l, w, h, yaw) in lidar frame; cameras z-forward/x-right/y-down;
sensor2lidar maps camera -> lidar; 2D annotations per camera in pixels.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

# camera looks along lidar +x: columns are the camera axes in lidar coords
# (cam x=right -> -y_lidar, cam y=down -> -z_lidar, cam z=fwd -> +x_lidar)
_CAM_R = np.array([[0.0, 0.0, 1.0],
                   [-1.0, 0.0, 0.0],
                   [0.0, -1.0, 0.0]])

# class -> ((l, w, h), BGR-ish color). Distinct colors make class identity
# learnable from pixels alone.
_CLASSES = {
    "car": ((4.2, 1.9, 1.6), (40, 40, 230)),
    "bus": ((10.0, 2.9, 3.4), (40, 230, 40)),
    "pedestrian": ((0.7, 0.7, 1.8), (230, 40, 40)),
}


def _project(K, cam_t, p_lidar):
    """-> (u, v, depth) of a lidar-frame point in a forward camera at
    lidar-frame translation cam_t."""
    p_cam = _CAM_R.T @ (p_lidar - cam_t)
    z = p_cam[2]
    if z <= 1.0:
        return None
    u = K[0, 0] * p_cam[0] / z + K[0, 2]
    v = K[1, 1] * p_cam[1] / z + K[1, 2]
    return u, v, z


def _scene_background(src_h, src_w, rng):
    """Per-scene procedural texture (fixed across the scene's frames).

    A uniform background starves detection training: with ~90% of patches
    identical across scenes, early (diffuse) cross-attention returns a
    scene-INDEPENDENT average and classification has no signal to
    bootstrap query grounding from — the model settles into the blind
    position-prior optimum (scores == marginal match rate). Low-frequency
    per-scene texture gives even unfocused attention a scene-dependent
    read, the same property real imagery has."""
    yy, xx = np.mgrid[0:src_h, 0:src_w].astype(np.float32)
    img = np.full((src_h, src_w, 3), 90.0, np.float32)
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            img[..., c] += 18.0 * np.sin(
                2 * np.pi * (fx * xx / src_w + fy * yy / src_h) + ph)
    return img.clip(20, 200)


def _render_view(K, cam_t, objects, src_h, src_w, rng, background=None):
    """Textured background + one filled rectangle per visible object
    (far to near), returns uint8 RGB plus per-object 2D annotations."""
    if background is None:
        background = _scene_background(src_h, src_w, rng)
    img = background.copy()
    boxes2d, centers2d, labels2d, depths = [], [], [], []
    order = np.argsort([-o["xyz"][0] for o in objects])     # far first
    for oi in order:
        o = objects[oi]
        proj = _project(K, cam_t, np.asarray(o["xyz"]))
        if proj is None:
            continue
        u, v, z = proj
        l, w, h = o["dims"]
        half_w = 0.5 * K[0, 0] * w / z
        half_h = 0.5 * K[1, 1] * h / z
        x0, x1 = int(u - half_w), int(u + half_w)
        y0, y1 = int(v - half_h), int(v + half_h)
        if x1 <= 0 or y1 <= 0 or x0 >= src_w or y0 >= src_h:
            continue
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x1, src_w), min(y1, src_h)
        if cx1 - cx0 < 2 or cy1 - cy0 < 2:
            continue
        img[cy0:cy1, cx0:cx1] = np.asarray(o["color"], np.float32)
        boxes2d.append([cx0, cy0, cx1, cy1])
        centers2d.append([u, v])
        labels2d.append(o["label"])
        depths.append(z)
    img = (img + rng.randn(src_h, src_w, 3) * 2).clip(0, 255)
    ann2d = {
        "bboxes2d": np.asarray(boxes2d, np.float32).reshape(-1, 4),
        "centers2d": np.asarray(centers2d, np.float32).reshape(-1, 2),
        "labels2d": np.asarray(labels2d, np.int64).reshape(-1),
        "depths": np.asarray(depths, np.float32).reshape(-1),
    }
    return img.astype(np.uint8), ann2d


def make_learnable_dataset(outdir: str, n_scenes: int = 2,
                           frames_per_scene: int = 8, n_cams: int = 2,
                           src_h: int = 180, src_w: int = 320,
                           n_objects: int = 4, seed: int = 0,
                           class_names: Optional[List[str]] = None,
                           drift: float = 0.0) -> str:
    """Write JPEGs + infos.pkl under outdir; returns the pkl path.

    Objects hold fixed per-scene positions (drift>0 adds per-frame motion
    with matching gt_velocity). Cameras: n_cams forward-looking cameras
    with lateral offsets — every object is visible in at least one view.
    """
    from ..configs.presets import CLASS_NAMES
    from PIL import Image

    class_names = class_names or list(_CLASSES)
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(outdir, "imgs")
    os.makedirs(img_dir, exist_ok=True)

    K = np.eye(3)
    K[0, 0] = K[1, 1] = 1.1 * src_w / 2
    K[0, 2], K[1, 2] = src_w / 2, src_h / 2

    infos = []
    t = 1_600_000_000_000_000      # microseconds
    dt = 0.5
    for s in range(n_scenes):
        objects = []
        for i in range(n_objects):
            name = class_names[i % len(class_names)]
            dims, color = _CLASSES[name]
            objects.append({
                "name": name,
                "label": CLASS_NAMES.index(name),
                "dims": dims,
                "color": color,
                "xyz": np.array([rng.uniform(10.0, 32.0),
                                 rng.uniform(-8.0, 8.0),
                                 dims[2] / 2]),
                "vel": (rng.randn(2) * drift if drift else np.zeros(2)),
            })
        cam_ts = [np.array([0.0, (c - (n_cams - 1) / 2) * 0.6, 1.6])
                  for c in range(n_cams)]
        backgrounds = [_scene_background(src_h, src_w, rng)
                       for _ in range(n_cams)]
        for f in range(frames_per_scene):
            cams = {}
            ann2d_per_cam = []
            for c, cam_t in enumerate(cam_ts):
                img, ann2d = _render_view(K, cam_t, objects, src_h, src_w,
                                          rng, background=backgrounds[c])
                path = os.path.join(img_dir, f"s{s}_f{f}_c{c}.jpg")
                Image.fromarray(img).save(path, quality=95)
                ann2d_per_cam.append(ann2d)
                cams[f"CAM{c}"] = {
                    "data_path": path,
                    "cam_intrinsic": K.copy(),
                    "sensor2lidar_rotation": _CAM_R.copy(),
                    "sensor2lidar_translation": cam_t.copy(),
                    "timestamp": t,
                }
            gt = np.stack([np.concatenate([o["xyz"], o["dims"], [0.0]])
                           for o in objects])
            infos.append({
                "cams": cams,
                "token": f"s{s}f{f}",
                "scene_token": f"scene{s}",
                "timestamp": t,
                "prev": "" if f == 0 else f"s{s}f{f-1}",
                "next": "",
                "frame_idx": f,
                "lidar_path": "none.bin",
                "sweeps": [] if f == 0 else [{"fake": 1}],
                "ego2global_rotation": [1, 0, 0, 0],
                "ego2global_translation": [0.0, 0.0, 0.0],
                "lidar2ego_rotation": [1, 0, 0, 0],
                "lidar2ego_translation": [0.0, 0.0, 0.0],
                "gt_boxes": gt.astype(np.float64),
                "gt_velocity": np.stack([o["vel"] for o in objects]),
                "gt_names": np.asarray([o["name"] for o in objects]),
                "valid_flag": np.ones(n_objects, bool),
                "num_lidar_pts": np.full(n_objects, 10),
                "bboxes2d": [a["bboxes2d"] for a in ann2d_per_cam],
                "labels2d": [a["labels2d"] for a in ann2d_per_cam],
                "centers2d": [a["centers2d"] for a in ann2d_per_cam],
                "depths": [a["depths"] for a in ann2d_per_cam],
                "bboxes_ignore": [np.zeros((0, 4), np.float32)
                                  for _ in range(n_cams)],
            })
            if drift:
                for o in objects:
                    o["xyz"][:2] += o["vel"] * dt
            t += int(dt * 1e6)
    path = os.path.join(outdir, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": infos,
                     "metadata": {"version": "v1.0-synthetic-learnable"}}, f)
    return path
