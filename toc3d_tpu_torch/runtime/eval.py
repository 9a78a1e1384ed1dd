"""Streaming evaluation and the nuScenes submission writer (counterpart of
toc3d_tpu/runtime/eval.py: velocity_attribute :44, CLASS_RANGE :64, the
quaternion helpers :71-84, detections_to_nusc_annos :87, write_submission
:142, streaming_eval :163, gather_results_multihost :195,
evaluate_submission :222).

Parity targets, as in the JAX package:
  streaming test loop          -> reference petr3d.py:507-594 +
                                  core/apis/test.py:45-113 (scene-ordered,
                                  per-scene memory reset)
  submission formatting        -> vendored mmdet3d nuscenes_dataset.py:301-368
                                  (_format_bbox, output_to_nusc_box,
                                  lidar_nusc_box_to_global, attribute rules)
  metric computation           -> nuscenes-devkit NuScenesEval when
                                  installed; otherwise
                                  toc3d_tpu_torch.runtime.nusc_metrics

The loop drives the port's ``infer(state, frame)``
(models/detector.make_infer_fn: on the card the captured frame, which reads
``steady`` from the host ``prev_exists``, so the loop sets it on the host
frame before the call). ``gather_results_multihost`` joins the ranks'
results of a distributed eval (tools/test.py --distributed).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from ..configs.presets import CLASS_NAMES

DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}

def velocity_attribute(name: str, speed: float) -> str:
    """The reference's speed-threshold attribute rule
    (nuscenes_dataset.py:335-355): moving/with_rider above 0.2 m/s, the
    class default (parked/standing/stopped) below."""
    if speed > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck",
                    "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE[name]
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE[name]


# detection_cvpr_2019 class ranges, clamped to max_depth=60
# (CustomNuScenesDataset.__init__, nuscenes_dataset.py:56-58)
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}


def yaw_to_quaternion(yaw: float) -> np.ndarray:
    """wxyz quaternion for rotation of `yaw` around +z."""
    return np.array([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])


def quat_multiply(q1, q2) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def detections_to_nusc_annos(boxes, scores, labels, info_meta,
                             class_names=CLASS_NAMES,
                             class_range=CLASS_RANGE) -> List[Dict]:
    """One sample's detections -> submission annotation dicts.

    boxes: (M, 9) bottom-z LiDAR boxes [x y z w l h yaw vx vy];
    info_meta: dict with lidar2ego_rotation/translation,
    ego2global_rotation/translation (wxyz quats + xyz).
    """
    from ..data.nuscenes import quaternion_rotation_matrix

    l2e_q = np.asarray(info_meta["lidar2ego_rotation"], np.float64)
    l2e_t = np.asarray(info_meta["lidar2ego_translation"], np.float64)
    e2g_q = np.asarray(info_meta["ego2global_rotation"], np.float64)
    e2g_t = np.asarray(info_meta["ego2global_translation"], np.float64)
    l2e_r = quaternion_rotation_matrix(l2e_q)
    e2g_r = quaternion_rotation_matrix(e2g_q)

    annos = []
    for i in range(len(boxes)):
        b = np.asarray(boxes[i], np.float64)
        center = b[:3].copy()
        center[2] += b[5] / 2.0                       # gravity center
        dims = b[3:6][[1, 0, 2]]                      # -> nus (w, l, h)
        quat = yaw_to_quaternion(b[6])
        vel = np.array([b[7], b[8], 0.0])

        # lidar -> ego
        center = l2e_r @ center + l2e_t
        vel = l2e_r @ vel
        quat = quat_multiply(l2e_q, quat)
        # range filter in ego frame (lidar_nusc_box_to_global)
        name = class_names[int(labels[i])]
        if np.linalg.norm(center[:2]) > class_range[name]:
            continue
        # ego -> global
        center = e2g_r @ center + e2g_t
        vel = e2g_r @ vel
        quat = quat_multiply(e2g_q, quat)

        attr = velocity_attribute(name, math.hypot(vel[0], vel[1]))

        annos.append({
            "sample_token": info_meta["token"],
            "translation": center.tolist(),
            "size": dims.tolist(),
            "rotation": quat.tolist(),
            "velocity": vel[:2].tolist(),
            "detection_name": name,
            "detection_score": float(scores[i]),
            "attribute_name": attr,
        })
    return annos


def write_submission(results: Dict[str, List[Dict]], out_dir: str,
                     modality: Optional[Dict] = None) -> str:
    """Write results_nusc.json byte-compatible with the reference."""
    os.makedirs(out_dir, exist_ok=True)
    sub = {
        "meta": modality or {
            "use_lidar": False, "use_camera": True, "use_radar": False,
            "use_map": False, "use_external": True,
        },
        "results": results,
    }
    path = os.path.join(out_dir, "results_nusc.json")
    with open(path, "w") as f:
        json.dump(sub, f)
    return path


# ---------------------------------------------------------------------------
# streaming eval loop
# ---------------------------------------------------------------------------

def sample_annos(det, meta) -> List[Dict]:
    """One frame's decoded boxes (batch lane 0; numpy arrays or host
    tensors) -> its submission annotations: the valid boxes through
    detections_to_nusc_annos."""
    boxes, scores, labels, valid = (np.asarray(t[0]) for t in (
        det.bboxes, det.scores, det.labels, det.valid))
    return detections_to_nusc_annos(boxes[valid], scores[valid],
                                    labels[valid], meta)


def streaming_eval(infer, init_state_fn, frames, metas,
                   progress_every: int = 250):
    """Scene-ordered streaming inference.

    infer(state, frame) -> (state, DecodedBoxes), as make_infer_fn returns
    it; frames: iterable of host frame dicts (B=1, numpy as
    build_eval_frame makes them); metas: matching list of dicts with
    token/scene_token + pose quats for formatting. prev_exists is set on
    each host frame before the call: 0 at a new scene_token, which resets
    the memory, else 1. Returns {sample_token: [annos...]} for
    write_submission.
    """
    results = {}
    state = None
    prev_scene = None
    for i, (frame, meta) in enumerate(zip(frames, metas)):
        if state is None:
            state = init_state_fn()
        prev_exists = 1.0 if meta["scene_token"] == prev_scene else 0.0
        prev_scene = meta["scene_token"]
        frame = dict(frame)
        frame["prev_exists"] = np.full_like(
            np.asarray(frame["prev_exists"]), prev_exists)
        state, det = infer(state, frame)
        results[meta["token"]] = sample_annos(
            type(det)(*(t.cpu() for t in det)), meta)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"eval: {i + 1} samples")
    return results


def gather_results_multihost(results: Dict[str, List[Dict]],
                             group=None) -> Dict:
    """Merge the ranks' eval results (the reference pickles each rank's
    part and joins them in rank order, core/apis/test.py:116-160; with
    contiguous chunks of scenes per rank a dict union keeps the global
    order). The same fixed-size exchange as JAX's: gather the blobs'
    lengths, pad each JSON blob to the longest, gather the blobs, join the
    dicts in rank order. Every rank gets the union; without a process group
    (or in a world of one) the results come back as they are. The
    exchange's tensors lie where the group's backend reduces: the current
    card for NCCL, the host for gloo."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return results
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    world = dist.get_world_size(group)
    raw = json.dumps(results).encode()
    n = torch.tensor([len(raw)], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lengths, n, group=group)
    lengths = [int(t) for t in lengths]
    padded = torch.zeros(max(lengths), dtype=torch.uint8)
    padded[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    padded = padded.to(dev)
    blobs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(blobs, padded, group=group)
    merged = {}
    for blob, size in zip(blobs, lengths):
        merged.update(json.loads(blob[:size].cpu().numpy().tobytes()
                                 .decode()))
    return merged


def evaluate_submission(result_path: str, data_root: str,
                        version: str = "v1.0-trainval",
                        eval_set: str = "val") -> Dict[str, float]:
    """Official devkit evaluation when installed, else the internal
    implementation (runtime/nusc_metrics.py) against a GT json."""
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.detection.evaluate import NuScenesEval
        from nuscenes.eval.detection.config import config_factory
    except ImportError:
        raise ImportError(
            "nuscenes-devkit not installed; use "
            "toc3d_tpu_torch.runtime.nusc_metrics.evaluate_json for the internal "
            "evaluator")
    nusc = NuScenes(version=version, dataroot=data_root, verbose=False)
    cfg = config_factory("detection_cvpr_2019")
    out_dir = os.path.dirname(result_path)
    ev = NuScenesEval(nusc, config=cfg, result_path=result_path,
                      eval_set=eval_set, output_dir=out_dir, verbose=False)
    ev.main(render_curves=False)
    with open(os.path.join(out_dir, "metrics_summary.json")) as f:
        metrics = json.load(f)
    return {"mAP": metrics["mean_ap"], "NDS": metrics["nd_score"]}
