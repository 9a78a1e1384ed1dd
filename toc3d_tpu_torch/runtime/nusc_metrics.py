"""Self-contained nuScenes detection metrics (mAP / TP errors / NDS); a
copy of toc3d_tpu/runtime/nusc_metrics.py.

Reimplements the nuscenes-devkit detection evaluation
(nuscenes/eval/detection/{algo,evaluate}.py semantics, config
detection_cvpr_2019) so accuracy can be measured without the devkit
installed. When the devkit is available, runtime/eval.py uses the official
path instead.

GT input format mirrors the submission format: per sample_token a list of
dicts with translation/size/rotation/velocity/detection_name/
attribute_name (+ optional ego_translation for range filtering, and
num_pts). build_gt_from_infos() produces this from the info pkl.
"""
from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_INTERP = 101

CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit LEAVES these out per class (class -> excluded metrics)
CLASS_TP_EXCLUDE = {
    "traffic_cone": {"orient_err", "vel_err", "attr_err"},
    "barrier": {"vel_err", "attr_err"},
}


def quat_yaw(q) -> float:
    """Yaw of a wxyz quaternion (devkit quaternion_yaw)."""
    w, x, y, z = q
    return math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def angle_diff(a: float, b: float, period: float) -> float:
    d = (a - b + period / 2) % period - period / 2
    if d > period / 2:
        d -= period
    return abs(d)


def scale_iou(size_a, size_b) -> float:
    """Aligned 3D IoU of sizes (devkit scale_iou)."""
    sa = np.maximum(np.asarray(size_a, np.float64), 1e-9)
    sb = np.maximum(np.asarray(size_b, np.float64), 1e-9)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union


def _filter_by_range(boxes: List[Dict], class_range=CLASS_RANGE):
    out = []
    for b in boxes:
        name = b["detection_name"]
        if name not in class_range:
            continue
        ego = b.get("ego_translation")
        if ego is None:
            out.append(b)
            continue
        dist = math.hypot(b["translation"][0] - ego[0],
                          b["translation"][1] - ego[1])
        if dist <= class_range[name]:
            out.append(b)
    return out


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit utils.cummean: NaN entries excluded from the running mean
    (0 where no non-NaN seen yet; all ones when everything is NaN)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals != 0)


def _no_predictions(npos: int) -> Dict:
    return {"precision": np.zeros(N_INTERP),
            "recall": np.linspace(0, 1, N_INTERP),
            "confidence": np.zeros(N_INTERP),
            **{k: np.ones(N_INTERP) for k in TP_METRICS},
            "max_recall_ind": 0, "npos": npos}


def accumulate(gt_all: Dict[str, List[Dict]], pred_all: Dict[str, List[Dict]],
               class_name: str, dist_th: float):
    """devkit algo.accumulate: greedy score-ordered center-distance match.

    Devkit-exact details pinned by tests/test_metrics_agreement.py:
    score ties order by HIGHER flat index first (the devkit sorts
    (value, index) ascending then reverses); ZERO MATCHES (not zero
    predictions) returns the no_predictions curve; attribute error is NaN
    when the GT carries no attribute and the cummean is NaN-aware;
    max_recall_ind is the last index with nonzero interpolated confidence.
    """
    npos = sum(1 for boxes in gt_all.values()
               for b in boxes if b["detection_name"] == class_name)
    if npos == 0:
        return None

    preds = [(tok, b) for tok, boxes in pred_all.items() for b in boxes
             if b["detection_name"] == class_name]
    order = sorted(range(len(preds)),
                   key=lambda i: (preds[i][1]["detection_score"], i))[::-1]
    preds = [preds[i] for i in order]

    gt_index = {tok: [b for b in boxes if b["detection_name"] == class_name]
                for tok, boxes in gt_all.items()}
    taken = defaultdict(set)

    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_conf = []
    for tok, pred in preds:
        gts = gt_index.get(tok, [])
        best, best_dist = None, float("inf")
        for gi, gt in enumerate(gts):
            if gi in taken[tok]:
                continue
            d = math.hypot(pred["translation"][0] - gt["translation"][0],
                           pred["translation"][1] - gt["translation"][1])
            if d < best_dist:
                best, best_dist = gi, d
        is_match = best is not None and best_dist < dist_th
        conf.append(pred["detection_score"])
        if is_match:
            taken[tok].add(best)
            tp.append(1)
            fp.append(0)
            gt = gts[best]
            match_data["trans_err"].append(best_dist)
            match_data["scale_err"].append(
                1 - scale_iou(gt["size"], pred["size"]))
            period = math.pi if class_name == "barrier" else 2 * math.pi
            match_data["orient_err"].append(
                angle_diff(quat_yaw(pred["rotation"]),
                           quat_yaw(gt["rotation"]), period))
            match_data["vel_err"].append(
                math.hypot(pred["velocity"][0] - gt["velocity"][0],
                           pred["velocity"][1] - gt["velocity"][1]))
            gt_attr = gt.get("attribute_name", "")
            match_data["attr_err"].append(
                np.nan if gt_attr == ""
                else 1.0 - float(pred.get("attribute_name", "") == gt_attr))
            match_conf.append(pred["detection_score"])
        else:
            tp.append(0)
            fp.append(1)

    if len(match_conf) == 0:
        return _no_predictions(npos)

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.asarray(conf, np.float64)
    prec = tp / (tp + fp)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_INTERP)
    precision = np.interp(rec_interp, rec, prec, right=0)
    confidence = np.interp(rec_interp, rec, conf, right=0)
    nonzero = np.nonzero(confidence)[0]
    out = {"precision": precision, "recall": rec_interp,
           "confidence": confidence, "npos": npos,
           "max_recall_ind": int(nonzero[-1]) if len(nonzero) else 0}

    match_conf = np.asarray(match_conf, np.float64)
    for key in TP_METRICS:
        cm = _cummean(np.asarray(match_data[key], np.float64))
        out[key] = np.interp(confidence[::-1], match_conf[::-1],
                             cm[::-1])[::-1]
    return out


def calc_ap(md) -> float:
    first = round(100 * MIN_RECALL) + 1
    prec = md["precision"][first:].copy()
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1 - MIN_PRECISION)


def calc_tp(md, metric_name: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = md["max_recall_ind"]
    if last < first:
        return 1.0
    return float(np.mean(md[metric_name][first:last + 1]))


def evaluate(gt_all: Dict[str, List[Dict]], pred_all: Dict[str, List[Dict]],
             class_names=tuple(CLASS_RANGE),
             max_boxes_per_sample: int = 500) -> Dict:
    """Full evaluation -> {mAP, NDS, per-class APs, TP errors}."""
    gt_all = {tok: _filter_by_range(b) for tok, b in gt_all.items()}
    pred_all = {tok: sorted(_filter_by_range(b),
                            key=lambda a: -a["detection_score"]
                            )[:max_boxes_per_sample]
                for tok, b in pred_all.items()}

    label_aps = {}
    label_tp = {}
    for cls in class_names:
        mds = {}
        for th in DIST_THS:
            mds[th] = accumulate(gt_all, pred_all, cls, th)
        label_aps[cls] = {th: (calc_ap(mds[th]) if mds[th] else 0.0)
                          for th in DIST_THS}
        md_tp = mds[DIST_TH_TP]
        label_tp[cls] = {}
        for m in TP_METRICS:
            if m in CLASS_TP_EXCLUDE.get(cls, ()):  # devkit: fixed 1.0
                label_tp[cls][m] = np.nan
            elif md_tp is None:
                label_tp[cls][m] = 1.0
            else:
                label_tp[cls][m] = calc_tp(md_tp, m)

    mean_ap = float(np.mean([ap for cls in class_names
                             for ap in label_aps[cls].values()]))
    tp_errors = {}
    for m in TP_METRICS:
        vals = [label_tp[cls][m] for cls in class_names
                if not np.isnan(label_tp[cls][m])]
        tp_errors[m] = float(np.mean(vals)) if vals else 1.0

    nds = (5 * mean_ap + sum(1 - min(1.0, tp_errors[m])
                             for m in TP_METRICS)) / 10.0
    return {"mAP": mean_ap, "NDS": nds, "label_aps": label_aps,
            "tp_errors": tp_errors}


def evaluate_json(result_path: str, gt_path: str) -> Dict:
    with open(result_path) as f:
        preds = json.load(f)["results"]
    with open(gt_path) as f:
        gt = json.load(f)
        gt = gt.get("results", gt)
    return evaluate(gt, preds)


def build_gt_from_infos(infos) -> Dict[str, List[Dict]]:
    """GT submission-format dicts from the temporal info pkl entries."""
    from ..data.nuscenes import quaternion_rotation_matrix, pose_matrix
    from ..runtime.eval import (yaw_to_quaternion, quat_multiply,
                                velocity_attribute)
    from ..configs.presets import CLASS_NAMES

    out = {}
    for info in infos:
        l2e_q = np.asarray(info["lidar2ego_rotation"], np.float64)
        l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
        e2g_q = np.asarray(info["ego2global_rotation"], np.float64)
        e2g_t = np.asarray(info["ego2global_translation"], np.float64)
        l2e_r = quaternion_rotation_matrix(l2e_q)
        e2g_r = quaternion_rotation_matrix(e2g_q)
        boxes = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 7)
        vels = np.nan_to_num(
            np.asarray(info["gt_velocity"], np.float64).reshape(-1, 2))
        names = list(info["gt_names"])
        annos = []
        for i in range(len(boxes)):
            if names[i] not in CLASS_RANGE:
                continue
            center = boxes[i, :3].copy()      # info boxes are gravity-z
            dims = boxes[i, 3:6][[1, 0, 2]]
            quat = yaw_to_quaternion(boxes[i, 6])
            vel = np.array([vels[i, 0], vels[i, 1], 0.0])
            center_e = l2e_r @ center + l2e_t
            vel = l2e_r @ vel
            quat = quat_multiply(l2e_q, quat)
            center_g = e2g_r @ center_e + e2g_t
            vel = e2g_r @ vel
            quat = quat_multiply(e2g_q, quat)
            annos.append({
                "translation": center_g.tolist(),
                "size": dims.tolist(),
                "rotation": quat.tolist(),
                "velocity": vel[:2].tolist(),
                "detection_name": names[i],
                # real nuScenes GT carries an attribute per box; synthetic
                # infos don't, so derive it with the same speed rule the
                # prediction path uses (nuscenes_dataset.py:335-355)
                "attribute_name": velocity_attribute(
                    names[i], float(np.hypot(vel[0], vel[1]))),
                "ego_translation": (e2g_t).tolist(),
            })
        out[info["token"]] = annos
    return out
