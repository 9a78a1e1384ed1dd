"""Offline tracking-by-detection on detection JSON (velocity-backcast
center matching, greedy or Hungarian assignment, age-based track life); a
copy of toc3d_tpu/tracking/pub_tracker.py.

Parity target: reference nusc_tracking/pub_tracker.py + track_utils.py +
pub_test.py (main loop with per-scene reset and time-lag bookkeeping).
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

NUSCENES_TRACKING_NAMES = (
    "car", "truck", "bus", "trailer", "motorcycle", "bicycle", "pedestrian")

# class-gated matching distance (pub_tracker.py:15-23)
NUSCENE_CLS_VELOCITY_ERROR = {n: 2.5 for n in NUSCENES_TRACKING_NAMES}


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Row-greedy nearest assignment (track_utils.py:3-12)."""
    matched = []
    if dist.shape[1] == 0:
        return np.array(matched, np.int32).reshape(-1, 2)
    for i in range(dist.shape[0]):
        j = dist[i].argmin()
        if dist[i][j] < 1e16:
            dist[:, j] = 1e18
            matched.append([i, j])
    return np.array(matched, np.int32).reshape(-1, 2)


class PubTracker:
    """strict_parity replicates a reference quirk on EMPTY input frames
    (pub_tracker.py:41-59): the reference ages surviving tracks but leaves
    self.tracks UNPRUNED, so expired tracks linger and can later be revived
    by a match (matching resets age to 1 regardless of prior age). Default
    False prunes expired tracks on every path — cleaner, and identical
    whenever no frame has a literally-empty detection list."""

    def __init__(self, hungarian: bool = False, max_age: int = 0,
                 strict_parity: bool = False):
        self.hungarian = hungarian
        self.max_age = max_age
        self.strict_parity = strict_parity
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: List[Dict] = []

    def _age_out(self) -> List[Dict]:
        ret = []
        for track in self.tracks:
            if track["age"] < self.max_age:
                track["age"] += 1
                track["active"] = 0
                if "tracking" in track:
                    track["ct"] = track["ct"] - track["tracking"]
                ret.append(track)
        return ret

    def step_centertrack(self, results: List[Dict], time_lag: float,
                         score_threshold: float) -> List[Dict]:
        """One frame (pub_tracker.py:41-186). results: detection dicts in
        submission format; mutates + returns live tracks."""
        if len(results) == 0:
            if self.strict_parity:
                # reference empty-input branch: age in place, no pruning
                ret = []
                for track in self.tracks:
                    if track["age"] < self.max_age:
                        track["age"] += 1
                        track["active"] = 0
                        if "tracking" in track:
                            track["ct"] = track["ct"] - track["tracking"]
                        ret.append(track)
                return ret
            ret = self._age_out() if self.tracks else []
            self.tracks = ret if self.tracks else []
            return ret

        temp = []
        for det in results:
            if det["detection_name"] not in NUSCENES_TRACKING_NAMES:
                continue
            if det["detection_score"] < score_threshold:
                continue
            det = dict(det)
            det["ct"] = np.array(det["translation"][:2])
            det["tracking"] = np.array(det["velocity"][:2]) * -1 * time_lag
            det["label_preds"] = NUSCENES_TRACKING_NAMES.index(
                det["detection_name"])
            temp.append(det)
        results = temp

        n, m = len(results), len(self.tracks)
        if n == 0:
            ret = self._age_out() if self.tracks else []
            self.tracks = ret if self.tracks else []
            return ret

        dets = np.array([d["ct"] + d["tracking"] for d in results],
                        np.float32)
        item_cat = np.array([d["label_preds"] for d in results], np.int32)
        track_cat = np.array([t["label_preds"] for t in self.tracks],
                             np.int32)
        max_diff = np.array(
            [NUSCENE_CLS_VELOCITY_ERROR[d["detection_name"]]
             for d in results], np.float32)
        tracks = np.array([t["ct"] for t in self.tracks], np.float32)

        if len(tracks) > 0:
            dist = np.sqrt(((tracks.reshape(1, -1, 2)
                             - dets.reshape(-1, 1, 2)) ** 2).sum(axis=2))
            invalid = ((dist > max_diff.reshape(n, 1))
                       | (item_cat.reshape(n, 1) != track_cat.reshape(1, m)))
            dist = dist + invalid * 1e18
            if self.hungarian:
                from scipy.optimize import linear_sum_assignment
                dist[dist > 1e18] = 1e18
                rows, cols = linear_sum_assignment(copy.deepcopy(dist))
                matched_indices = np.stack([rows, cols], axis=1)
            else:
                matched_indices = greedy_assignment(copy.deepcopy(dist))
        else:
            matched_indices = np.array([], np.int32).reshape(-1, 2)

        unmatched_dets = [d for d in range(n)
                          if d not in matched_indices[:, 0]]
        unmatched_tracks = [d for d in range(m)
                            if d not in matched_indices[:, 1]]

        if self.hungarian:
            matches = []
            for mm in matched_indices:
                if dist[mm[0], mm[1]] > 1e16:
                    unmatched_dets.append(mm[0])
                else:
                    matches.append(mm)
            matches = np.array(matches).reshape(-1, 2)
        else:
            matches = matched_indices

        ret = []
        for mm in matches:
            track = results[mm[0]]
            track["tracking_id"] = self.tracks[mm[1]]["tracking_id"]
            track["age"] = 1
            track["active"] = self.tracks[mm[1]]["active"] + 1
            ret.append(track)
        for i in unmatched_dets:
            track = results[i]
            self.id_count += 1
            track["tracking_id"] = self.id_count
            track["age"] = 1
            track["active"] = 1
            ret.append(track)
        for i in unmatched_tracks:
            track = self.tracks[i]
            if track["age"] < self.max_age:
                track["age"] += 1
                track["active"] = 0
                if "tracking" in track:
                    track["ct"] = track["ct"] - track["tracking"]
                ret.append(track)

        self.tracks = ret
        return ret


def track_detections(predictions: Dict[str, List[Dict]],
                     frames: List[Dict], max_age: int = 3,
                     score_threshold: float = 0.25,
                     hungarian: bool = False,
                     strict_parity: bool = False) -> Dict:
    """The pub_test.py main loop: stream frames (dicts with token/timestamp/
    first), reset per scene, return tracking submission results.

    frames can be built from the info pkl: first = (prev_exists is False).
    """
    tracker = PubTracker(max_age=max_age, hungarian=hungarian,
                         strict_parity=strict_parity)
    nusc_annos = {}
    last_ts = 0.0
    t0 = time.time()
    for frame in frames:
        token = frame["token"]
        if frame["first"]:
            tracker.reset()
            last_ts = frame["timestamp"]
        time_lag = frame["timestamp"] - last_ts
        last_ts = frame["timestamp"]
        outputs = tracker.step_centertrack(
            predictions.get(token, []), time_lag, score_threshold)
        annos = []
        for item in outputs:
            if item["active"] == 0:
                continue
            annos.append({
                "sample_token": token,
                "translation": list(item["translation"]),
                "size": list(item["size"]),
                "rotation": list(item["rotation"]),
                "velocity": list(item["velocity"]),
                "tracking_id": str(item["tracking_id"]),
                "tracking_name": item["detection_name"],
                "tracking_score": item["detection_score"],
            })
        nusc_annos[token] = annos
    fps = len(frames) / max(time.time() - t0, 1e-9)
    return {"results": nusc_annos, "meta": {
        "use_camera": True, "use_lidar": False, "use_radar": False,
        "use_map": False, "use_external": False}, "fps": fps}


def frames_from_infos(infos) -> List[Dict]:
    """frames_meta from the temporal info pkl (replaces pub_test.py
    save_first_frame's devkit dependency): a frame is 'first' when the
    previous sample belongs to another scene."""
    frames = []
    prev_scene = None
    for info in infos:
        frames.append({
            "token": info["token"],
            "timestamp": info["timestamp"] * 1e-6,
            "first": info["scene_token"] != prev_scene,
        })
        prev_scene = info["scene_token"]
    return frames


def write_tracking_result(result: Dict, work_dir: str) -> str:
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "tracking_result.json")
    with open(path, "w") as f:
        json.dump(result, f)
    return path
