"""Self-contained nuScenes tracking metrics (AMOTA / AMOTP / MOTAR); a
copy of toc3d_tpu/tracking/metrics.py. The assignment is the port's
native C++ LAP solver (native/lap.cpp, the JAX package's own), as JAX's
``_hungarian`` uses it (metrics.py:69-91); a build failure raises.

Restates the nuscenes-devkit `tracking_nips_2019` evaluation
(nuscenes/eval/tracking/{algo,metrics}.py + the motmetrics accumulation it
builds on) so `tools/track.py` ends in numbers without the devkit — the same
gap runtime/nusc_metrics.py closes for detection. Reference entry point:
reference nusc_tracking/pub_test.py:165-183.

Restated semantics (from the published nuScenes tracking protocol / AB3DMOT
AMOTA definition):
  * per class (7 tracking classes), frames are accumulated per scene with a
    MOT correspondence rule: matches from the previous frame are kept when
    still feasible (center distance <= 2 m), the remainder is matched by
    Hungarian assignment on center distance; a match whose track id differs
    from the GT's most recent association counts as an identity switch.
  * an unthresholded pass collects the scores of all TP matches; recall
    targets are the 40 values linspace(0.1, 1), each mapped to the score
    threshold that first achieves it (unachievable -> worst-case values:
    MOTAR 0, MOTP 2.0).
  * per threshold: MOTAR = max(0, 1 - (IDS + FP + FN - (1-r)*P) / (r*P))
    with r the achieved recall and P the GT count; MOTP = mean TP distance.
  * AMOTA / AMOTP = mean over the 40 thresholds, then over classes.

Bookkeeping is motmetrics-exact (persistent last-known correspondences,
devkit-interpolated recall thresholds): pinned by hand fixtures in
tests/test_tracking_metrics.py AND a 50-scenario randomized agreement suite
against an independent literal transcription of the devkit algorithm
(tests/test_metrics_agreement.py / devkit_tracking_transcription.py).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

TRACKING_NAMES = ("bicycle", "bus", "car", "motorcycle", "pedestrian",
                  "trailer", "truck")
DIST_TH_TP = 2.0
NUM_THRESHOLDS = 40
MIN_RECALL = 0.1
MOTAR_WORST = 0.0
MOTP_WORST = DIST_TH_TP
CLASS_RANGE = {"car": 50, "truck": 50, "bus": 50, "trailer": 50,
               "pedestrian": 40, "motorcycle": 40, "bicycle": 40}


def _center_dist(a, b) -> float:
    return math.hypot(a[0] - b[0], a[1] - b[1])


def _filter_range(boxes: List[Dict], name_key: str) -> List[Dict]:
    out = []
    for b in boxes:
        name = b[name_key]
        if name not in CLASS_RANGE:
            continue
        ego = b.get("ego_translation")
        if ego is not None:
            d = math.hypot(b["translation"][0] - ego[0],
                           b["translation"][1] - ego[1])
            if d > CLASS_RANGE[name]:
                continue
        out.append(b)
    return out


def _hungarian(dist: np.ndarray):
    """Small exact LAP on a (possibly infeasible) distance matrix; returns
    row->col matches with finite cost (metrics.py:69-91): the native
    solver, on the transpose when rows outnumber columns."""
    if dist.size == 0:
        return []
    from ..native import lap_batched
    big = 1e6
    cost = np.where(np.isfinite(dist), dist, big).astype(np.float32)
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = np.ascontiguousarray(cost.T)
    res = lap_batched(cost[None], np.array([cost.shape[0]], np.int32))
    pairs = [(i, int(j)) for i, j in enumerate(res[0]) if j >= 0]
    if transposed:
        pairs = [(j, i) for i, j in pairs]
    return [(int(i), int(j)) for i, j in pairs if np.isfinite(dist[i, j])]


class MotAccumulator:
    """Per-scene, per-class MOT event accumulation (exact motmetrics
    MOTAccumulator semantics, pinned by tests/test_metrics_agreement.py):
    each GT's LAST KNOWN correspondence (persistent across frames with
    gaps, motmetrics self.m) is re-established first whenever that
    hypothesis is present and within dist_th — always a MATCH; the
    remainder is matched by Hungarian assignment; a Hungarian pair whose
    hypothesis differs from the GT's last known one is a SWITCH.
    Feasibility is strict (d < dist_th, devkit sets d >= th to NaN)."""

    def __init__(self):
        self.last_match: Dict[str, str] = {}   # motmetrics self.m
        self.n_matches = 0
        self.n_switches = 0
        self.n_fp = 0
        self.n_miss = 0
        self.n_gt = 0
        self.dist_sum = 0.0
        self.tp_scores: List[float] = []       # scores of TP matches

    def update(self, gts: List[Dict], hyps: List[Dict]):
        """gts: dicts with tracking_id/translation; hyps additionally with
        tracking_score."""
        self.n_gt += len(gts)
        gt_ids = [g["tracking_id"] for g in gts]
        hyp_ids = [h["tracking_id"] for h in hyps]
        dist = np.full((len(gts), len(hyps)), np.inf)
        for i, g in enumerate(gts):
            for j, h in enumerate(hyps):
                d = _center_dist(g["translation"], h["translation"])
                if d < DIST_TH_TP:
                    dist[i, j] = d

        pairs = []
        used_g, used_h = set(), set()
        # 1) re-establish last-known correspondences while feasible
        #    (always counts as MATCH, motmetrics phase 1)
        for i, gid in enumerate(gt_ids):
            hid = self.last_match.get(gid)
            if hid is None or hid not in hyp_ids:
                continue
            j = hyp_ids.index(hid)
            if j in used_h:
                continue
            if np.isfinite(dist[i, j]):
                pairs.append((i, j, False))
                used_g.add(i)
                used_h.add(j)
        # 2) Hungarian on the remainder; switch iff the GT had a different
        #    last-known hypothesis (motmetrics phase 2)
        free_g = [i for i in range(len(gts)) if i not in used_g]
        free_h = [j for j in range(len(hyps)) if j not in used_h]
        if free_g and free_h:
            sub = dist[np.ix_(free_g, free_h)]
            for r, c in _hungarian(sub):
                i, j = free_g[r], free_h[c]
                gid, hid = gt_ids[i], hyp_ids[j]
                is_switch = (gid in self.last_match
                             and self.last_match[gid] != hid)
                pairs.append((i, j, is_switch))

        for i, j, is_switch in pairs:
            gid, hid = gt_ids[i], hyp_ids[j]
            if is_switch:
                self.n_switches += 1
            else:
                self.n_matches += 1
            self.last_match[gid] = hid
            self.dist_sum += dist[i, j]
            self.tp_scores.append(hyps[j].get("tracking_score", 0.0))
        matched_h = {j for _, j, _ in pairs}
        matched_g = {i for i, _, _ in pairs}
        self.n_fp += len(hyps) - len(matched_h)
        self.n_miss += len(gts) - len(matched_g)

    @property
    def n_tp(self) -> int:
        return self.n_matches + self.n_switches


def _accumulate_class(gt_frames, pred_frames, scenes, cls, threshold):
    """Run accumulation for one class over all scenes at a score threshold
    (None = unthresholded pass). Returns aggregate counters."""
    agg = {"tp": 0, "fp": 0, "miss": 0, "switch": 0, "gt": 0,
           "dist": 0.0, "scores": []}
    for scene_tokens in scenes:
        acc = MotAccumulator()
        for tok in scene_tokens:
            gts = [g for g in gt_frames.get(tok, [])
                   if g["tracking_name"] == cls]
            hyps = [h for h in pred_frames.get(tok, [])
                    if h["tracking_name"] == cls
                    and (threshold is None
                         or h.get("tracking_score", 0.0) >= threshold)]
            acc.update(gts, hyps)
        agg["tp"] += acc.n_tp
        agg["fp"] += acc.n_fp
        agg["miss"] += acc.n_miss
        agg["switch"] += acc.n_switches
        agg["gt"] += acc.n_gt
        agg["dist"] += acc.dist_sum
        agg["scores"].extend(acc.tp_scores)
    return agg


def _thresholds_from_scores(scores: List[float], n_gt: int):
    """Map the 40 target recalls to score thresholds (devkit
    compute_thresholds, exact): thresholds = np.interp(rec_interp, rec,
    scores-desc); recalls beyond the max achieved recall -> None (devkit
    NaN -> worst-case values)."""
    recalls = np.linspace(MIN_RECALL, 1.0, NUM_THRESHOLDS).round(12)
    if n_gt == 0 or len(scores) == 0:
        return [None] * NUM_THRESHOLDS, recalls
    s = np.sort(np.asarray(scores, np.float64))[::-1]
    rec = np.arange(1, len(s) + 1) / n_gt
    max_recall_achieved = float(np.max(rec))
    ths = np.interp(recalls, rec, s, right=0)
    return [None if r > max_recall_achieved else float(t)
            for r, t in zip(recalls, ths)], recalls


def evaluate_tracking(gt_frames: Dict[str, List[Dict]],
                      pred_frames: Dict[str, List[Dict]],
                      scenes: List[List[str]],
                      class_names=TRACKING_NAMES) -> Dict:
    """gt_frames/pred_frames: sample_token -> list of dicts with
    translation (xy[z]), tracking_id, tracking_name (+ tracking_score for
    preds, optional ego_translation for range filtering).
    scenes: list of per-scene sample-token lists in temporal order.

    Returns {AMOTA, AMOTP, per-class amota/amotp/motar curves, counters}.
    """
    gt_frames = {t: _filter_range(b, "tracking_name")
                 for t, b in gt_frames.items()}
    pred_frames = {t: _filter_range(b, "tracking_name")
                   for t, b in pred_frames.items()}

    per_class = {}
    for cls in class_names:
        n_gt_cls = sum(1 for boxes in gt_frames.values()
                       for b in boxes if b["tracking_name"] == cls)
        if n_gt_cls == 0:
            continue
        first = _accumulate_class(gt_frames, pred_frames, scenes, cls, None)
        ths, recalls = _thresholds_from_scores(first["scores"], n_gt_cls)
        motars, motps = [], []
        for th, target_r in zip(ths, recalls):
            if th is None:
                motars.append(MOTAR_WORST)
                motps.append(MOTP_WORST)
                continue
            agg = _accumulate_class(gt_frames, pred_frames, scenes, cls, th)
            p = agg["gt"]
            r = agg["tp"] / p if p else 0.0
            if r <= 0:
                motars.append(MOTAR_WORST)
                motps.append(MOTP_WORST)
                continue
            nom = agg["switch"] + agg["fp"] + agg["miss"] - (1 - r) * p
            motars.append(max(0.0, 1.0 - nom / (r * p)))
            motps.append(agg["dist"] / agg["tp"] if agg["tp"] else MOTP_WORST)
        per_class[cls] = {
            "amota": float(np.mean(motars)),
            "amotp": float(np.mean(motps)),
            "motar": motars,
            "motp": motps,
            "num_gt": n_gt_cls,
        }

    if per_class:
        amota = float(np.mean([v["amota"] for v in per_class.values()]))
        amotp = float(np.mean([v["amotp"] for v in per_class.values()]))
    else:
        amota, amotp = 0.0, MOTP_WORST
    return {"AMOTA": amota, "AMOTP": amotp, "per_class": per_class,
            "evaluator": "internal"}


# ---------------------------------------------------------------------------
# GT assembly from the temporal info pkl
# ---------------------------------------------------------------------------

def build_tracking_gt_from_infos(infos) -> Dict[str, List[Dict]]:
    """Tracking GT (global frame, with per-annotation instance identity)
    from converter infos. Requires 'gt_instance_tokens' (written by
    data/convert.py; the devkit reads the same identity from the DB)."""
    from ..runtime.nusc_metrics import build_gt_from_infos
    from ..runtime.nusc_metrics import CLASS_RANGE as DET_CLASS_RANGE

    det_gt = build_gt_from_infos(infos)
    out = {}
    for info in infos:
        boxes = det_gt.get(info["token"], [])
        inst = list(info.get("gt_instance_tokens", []))
        names = list(info.get("gt_names", []))
        # build_gt_from_infos drops classes outside CLASS_RANGE, walk in sync
        kept_idx = [i for i, n in enumerate(names) if n in DET_CLASS_RANGE]
        annos = []
        for b, i in zip(boxes, kept_idx):
            if b["detection_name"] not in TRACKING_NAMES:
                continue
            a = dict(b)
            a["tracking_name"] = b["detection_name"]
            a["tracking_id"] = (inst[i] if i < len(inst)
                                else f"{info['token']}_{i}")
            annos.append(a)
        out[info["token"]] = annos
    return out


def scenes_from_infos(infos) -> List[List[str]]:
    scenes = []
    prev = None
    for info in infos:
        if info["scene_token"] != prev:
            scenes.append([])
            prev = info["scene_token"]
        scenes[-1].append(info["token"])
    return scenes
