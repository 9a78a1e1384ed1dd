"""nuScenes raw tables -> temporal info pkl, without the devkit (twin of
toc3d_tpu/data/convert.py; the reference's tools/create_data_nusc.py and
tools/data_converter/nuscenes_converter.py: create_nuscenes_infos,
_fill_trainval_infos:146, obtain_sensor2top:355, get_2d_boxes).

Writes nuscenes2d_temporal_infos_{train,val}.pkl with the schema the
dataset reader consumes (data/nuscenes.NuScenesInfos; the reference's
datasets/nuscenes_dataset.py:165-258), reading the raw JSON tables
(sample.json, sample_data.json, ego_pose.json, calibrated_sensor.json,
sample_annotation.json, instance.json, category.json, scene.json) directly.
Host-side numpy; the devkit's official split is imported at the call when
it is installed.

2D boxes as the reference post-processes them: the convex hull of the
projected in-front corners is intersected with the image canvas
(post_process_coords, restated without shapely as a monotone-chain hull
and Sutherland-Hodgman clipping) and the min/max of the intersection is
the 2D box.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .nuscenes import quaternion_rotation_matrix

CAMERA_TYPES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")

NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

NUS_CATEGORIES = ("car", "truck", "trailer", "bus", "construction_vehicle",
                  "bicycle", "motorcycle", "pedestrian", "traffic_cone",
                  "barrier")


def quat_inverse(q):
    w, x, y, z = q
    return np.array([w, -x, -y, -z], np.float64)


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_yaw(q) -> float:
    """Yaw of the rotated x-axis (devkit quaternion_yaw)."""
    r = quaternion_rotation_matrix(q)
    v = r @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


class NuScenesTables:
    """Raw JSON tables with token indices (the devkit's core)."""

    TABLES = ("scene", "sample", "sample_data", "ego_pose",
              "calibrated_sensor", "sensor", "sample_annotation",
              "instance", "category", "attribute", "visibility")

    def __init__(self, data_root: str, version: str = "v1.0-trainval"):
        self.data_root = data_root
        self.version = version
        table_dir = os.path.join(data_root, version)
        self._tables: Dict[str, Dict[str, Dict]] = {}
        for name in self.TABLES:
            path = os.path.join(table_dir, f"{name}.json")
            if not os.path.exists(path):
                self._tables[name] = {}
                continue
            with open(path) as f:
                rows = json.load(f)
            self._tables[name] = {r["token"]: r for r in rows}
        # ann lists per sample
        self._anns_by_sample: Dict[str, List[str]] = {}
        for tok, ann in self._tables["sample_annotation"].items():
            self._anns_by_sample.setdefault(ann["sample_token"],
                                            []).append(tok)

    def get(self, table: str, token: str) -> Dict:
        return self._tables[table][token]

    def all(self, table: str) -> List[Dict]:
        return list(self._tables[table].values())

    def sample_anns(self, sample_token: str) -> List[str]:
        return self._anns_by_sample.get(sample_token, [])

    def samples_in_order(self) -> List[Dict]:
        """Samples scene by scene following the prev/next chain (the devkit
        sorts its sample table this way on load)."""
        out = []
        for scene in self.all("scene"):
            tok = scene["first_sample_token"]
            while tok:
                s = self.get("sample", tok)
                out.append(s)
                tok = s["next"]
        return out

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5):
        """Finite-difference global velocity (devkit box_velocity)."""
        ann = self.get("sample_annotation", ann_token)
        has_prev = ann["prev"] != ""
        has_next = ann["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation",
                         ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation",
                        ann["next"]) if has_next else ann
        pos_first = np.asarray(first["translation"], np.float64)
        pos_last = np.asarray(last["translation"], np.float64)
        t_first = self.get("sample", first["sample_token"])["timestamp"] / 1e6
        t_last = self.get("sample", last["sample_token"])["timestamp"] / 1e6
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt


def _box_to_sensor(translation, rotation, ego_pose, calib):
    """Global-frame box -> sensor frame (devkit get_sample_data transforms:
    translate(-ego_t) rotate(ego_q^-1) translate(-cal_t) rotate(cal_q^-1))."""
    center = np.asarray(translation, np.float64)
    quat = np.asarray(rotation, np.float64)
    e_t = np.asarray(ego_pose["translation"], np.float64)
    e_q = np.asarray(ego_pose["rotation"], np.float64)
    c_t = np.asarray(calib["translation"], np.float64)
    c_q = np.asarray(calib["rotation"], np.float64)
    e_r_inv = quaternion_rotation_matrix(e_q).T
    c_r_inv = quaternion_rotation_matrix(c_q).T
    center = e_r_inv @ (center - e_t)
    center = c_r_inv @ (center - c_t)
    quat = quat_multiply(quat_inverse(c_q), quat_multiply(quat_inverse(e_q),
                                                          quat))
    return center, quat


def _sensor2lidar(tables, sd_rec, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat,
                  sensor_type):
    """obtain_sensor2top (nuscenes_converter.py:355-413)."""
    cs = tables.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose = tables.get("ego_pose", sd_rec["ego_pose_token"])
    info = {
        "data_path": os.path.join(tables.data_root, sd_rec["filename"]),
        "type": sensor_type,
        "sample_data_token": sd_rec["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd_rec["timestamp"],
    }
    l2e_r_s_mat = quaternion_rotation_matrix(cs["rotation"])
    e2g_r_s_mat = quaternion_rotation_matrix(pose["rotation"])
    l2e_t_s = np.asarray(cs["translation"], np.float64)
    e2g_t_s = np.asarray(pose["translation"], np.float64)
    l2e_t_ = np.asarray(l2e_t, np.float64)
    e2g_t_ = np.asarray(e2g_t, np.float64)

    r = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
    t = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
    t -= (e2g_t_ @ (np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
          + l2e_t_ @ np.linalg.inv(l2e_r_mat).T)
    info["sensor2lidar_rotation"] = r.T
    info["sensor2lidar_translation"] = t
    return info


def _box_corners(center, wlh, rot_mat):
    """devkit Box.corners(): x along l, y along w, z along h."""
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    return rot_mat @ np.stack([x, y, z]) + np.asarray(center)[:, None]


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone-chain convex hull. points: (N, 2) -> (H, 2) CCW."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        hull = []
        for p in iterable:
            while len(hull) >= 2 and cross2(hull[-2], hull[-1], p) <= 0:
                hull.pop()
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _clip_polygon(poly: np.ndarray, w: float, h: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon against [0,w]x[0,h]."""
    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            if inside(cur):
                out.append(cur)
                if not inside(nxt):
                    out.append(intersect(cur, nxt))
            elif inside(nxt):
                out.append(intersect(cur, nxt))
        return out

    def x_cut(x0):
        def f(a, b):
            t = (x0 - a[0]) / (b[0] - a[0])
            return np.array([x0, a[1] + t * (b[1] - a[1])])
        return f

    def y_cut(y0):
        def f(a, b):
            t = (y0 - a[1]) / (b[1] - a[1])
            return np.array([a[0] + t * (b[0] - a[0]), y0])
        return f

    pts = [p for p in np.asarray(poly, np.float64)]
    for inside, inter in (
            (lambda p: p[0] >= 0, x_cut(0.0)),
            (lambda p: p[0] <= w, x_cut(float(w))),
            (lambda p: p[1] >= 0, y_cut(0.0)),
            (lambda p: p[1] <= h, y_cut(float(h)))):
        if not pts:
            return np.zeros((0, 2))
        pts = clip_edge(pts, inside, inter)
    return np.asarray(pts).reshape(-1, 2)


def post_process_coords(corner_coords: np.ndarray, img_wh=(1600, 900)):
    """Convex hull of projected corners intersected with the image canvas
    (devkit nuscenes_converter.post_process_coords, restated without
    shapely). corner_coords: (N, 2) pixel uv of the in-front corners.
    Returns (x1, y1, x2, y2) or None when the hull misses the canvas."""
    hull = _convex_hull(np.asarray(corner_coords, np.float64))
    if len(hull) == 0:
        return None
    inter = _clip_polygon(hull, img_wh[0], img_wh[1])
    if len(inter) == 0:
        return None
    x1, y1 = inter.min(axis=0)
    x2, y2 = inter.max(axis=0)
    return float(x1), float(y1), float(x2), float(y2)


def _project_2d(tables, sample, cam_info, img_wh=(1600, 900),
                visibilities=("", "1", "2", "3", "4")):
    """Per-camera 2D annotations (get_2d_boxes semantics, incl. the
    hull-canvas intersection post-processing)."""
    sd = tables.get("sample_data", cam_info["sample_data_token"])
    calib = tables.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = tables.get("ego_pose", sd["ego_pose_token"])
    intr = np.asarray(calib["camera_intrinsic"], np.float64)
    w_img, h_img = img_wh

    bboxes, labels, centers, depths = [], [], [], []
    for tok in tables.sample_anns(sample["token"]):
        ann = tables.get("sample_annotation", tok)
        if ann.get("visibility_token", "") not in visibilities:
            continue
        inst = tables.get("instance", ann["instance_token"])
        cat = tables.get("category", inst["category_token"])["name"]
        if cat not in NAME_MAPPING:
            continue
        name = NAME_MAPPING[cat]
        center, quat = _box_to_sensor(ann["translation"], ann["rotation"],
                                      pose, calib)
        corners = _box_corners(center, ann["size"],
                               quaternion_rotation_matrix(quat))
        in_front = corners[2] > 0.1
        if not in_front.any():
            continue
        pts = corners[:, in_front]
        uv = (intr @ pts)
        uv = uv[:2] / uv[2]
        coords = post_process_coords(uv.T, (w_img, h_img))
        if coords is None:
            continue
        x1, y1, x2, y2 = coords
        if x2 <= x1 or y2 <= y1:
            continue
        if center[2] < 0.1:
            continue
        c_uv = intr @ center
        c_uv = c_uv[:2] / c_uv[2]
        bboxes.append([x1, y1, x2, y2])
        labels.append(NUS_CATEGORIES.index(name))
        centers.append(c_uv)
        depths.append(center[2])
    return (np.asarray(bboxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64).reshape(-1),
            np.asarray(centers, np.float32).reshape(-1, 2),
            np.asarray(depths, np.float32).reshape(-1))


def fill_trainval_infos(tables: NuScenesTables, with_2d: bool = True,
                        max_sweeps: int = 10, test: bool = False):
    """_fill_trainval_infos (nuscenes_converter.py:146-330) without the
    devkit. Returns the list of info dicts (caller splits train/val)."""
    infos = []
    frame_idx = 0
    for sample in tables.samples_in_order():
        sd_rec = tables.get("sample_data", sample["data"]["LIDAR_TOP"])
        cs = tables.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
        pose = tables.get("ego_pose", sd_rec["ego_pose_token"])
        l2e_r_mat = quaternion_rotation_matrix(cs["rotation"])
        e2g_r_mat = quaternion_rotation_matrix(pose["rotation"])

        info = {
            "lidar_path": os.path.join(tables.data_root, sd_rec["filename"]),
            "token": sample["token"],
            "prev": sample["prev"],
            "next": sample["next"],
            "sweeps": [],
            "frame_idx": frame_idx,
            "cams": {},
            "scene_token": sample["scene_token"],
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }
        frame_idx = 0 if sample["next"] == "" else frame_idx + 1

        cams_present = [c for c in CAMERA_TYPES if c in sample["data"]]
        for cam in cams_present:
            cam_sd = tables.get("sample_data", sample["data"][cam])
            cam_info = _sensor2lidar(tables, cam_sd, cs["translation"],
                                     l2e_r_mat, pose["translation"],
                                     e2g_r_mat, cam)
            calib = tables.get("calibrated_sensor",
                               cam_sd["calibrated_sensor_token"])
            cam_info["cam_intrinsic"] = np.asarray(calib["camera_intrinsic"],
                                                   np.float64)
            info["cams"][cam] = cam_info

        # lidar sweeps (used downstream only for scene-start detection +
        # point aggregation)
        rec = sd_rec
        while len(info["sweeps"]) < max_sweeps and rec["prev"]:
            rec = tables.get("sample_data", rec["prev"])
            info["sweeps"].append(_sensor2lidar(
                tables, rec, cs["translation"], l2e_r_mat,
                pose["translation"], e2g_r_mat, "lidar"))

        if not test:
            gt_boxes, names, velocity = [], [], []
            num_lidar, num_radar, valid, inst_toks = [], [], [], []
            for tok in tables.sample_anns(sample["token"]):
                ann = tables.get("sample_annotation", tok)
                inst_toks.append(ann["instance_token"])
                center, quat = _box_to_sensor(ann["translation"],
                                              ann["rotation"], pose, cs)
                yaw = quat_yaw(quat)
                w, l, h = ann["size"]
                gt_boxes.append([*center, l, w, h, yaw])
                inst = tables.get("instance", ann["instance_token"])
                cat = tables.get("category", inst["category_token"])["name"]
                names.append(NAME_MAPPING.get(cat, cat))
                velo = tables.box_velocity(tok)
                velo = np.array([*velo[:2], 0.0]) @ np.linalg.inv(
                    e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
                velocity.append(velo[:2])
                num_lidar.append(ann.get("num_lidar_pts", 0))
                num_radar.append(ann.get("num_radar_pts", 0))
                valid.append((ann.get("num_lidar_pts", 0)
                              + ann.get("num_radar_pts", 0)) > 0)
            info["gt_boxes"] = np.asarray(gt_boxes, np.float64).reshape(-1, 7)
            info["gt_names"] = np.asarray(names)
            info["gt_velocity"] = np.asarray(velocity,
                                             np.float64).reshape(-1, 2)
            info["num_lidar_pts"] = np.asarray(num_lidar)
            info["num_radar_pts"] = np.asarray(num_radar)
            info["valid_flag"] = np.asarray(valid, bool)
            # instance identity for tracking GT (the devkit's TrackingEval
            # reads this from the DB; we persist it so tracking metrics are
            # computable devkit-free, see tracking/metrics.py)
            info["gt_instance_tokens"] = np.asarray(inst_toks)

            if with_2d:
                b2, l2, c2, d2 = [], [], [], []
                for cam in cams_present:
                    bb, ll, cc, dd = _project_2d(tables, sample,
                                                 info["cams"][cam])
                    b2.append(bb)
                    l2.append(ll)
                    c2.append(cc)
                    d2.append(dd)
                info["bboxes2d"] = b2
                info["labels2d"] = l2
                info["centers2d"] = c2
                info["depths"] = d2
                info["bboxes_ignore"] = [np.zeros((0, 4), np.float32)
                                         for _ in cams_present]
        infos.append(info)
    return infos


def create_nuscenes_infos(data_root: str, version: str = "v1.0-trainval",
                          out_dir: Optional[str] = None,
                          val_scene_names: Optional[Sequence[str]] = None):
    """Write nuscenes2d_temporal_infos_{train,val}.pkl.

    val_scene_names: scene names for the val split; defaults to the official
    devkit split when nuscenes-devkit is installed, else everything goes to
    a single 'val' file.
    """
    out_dir = out_dir or data_root
    tables = NuScenesTables(data_root, version)
    infos = fill_trainval_infos(tables, test="test" in version)

    if val_scene_names is None:
        try:
            from nuscenes.utils import splits
            val_scene_names = set(splits.val)
        except ImportError:
            val_scene_names = None

    scene_name = {s["token"]: s["name"] for s in tables.all("scene")}
    metadata = {"version": version}
    paths = []
    if val_scene_names is None:
        path = os.path.join(out_dir, "nuscenes2d_temporal_infos_val.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": infos, "metadata": metadata}, f)
        paths.append(path)
        return paths

    train = [i for i in infos
             if scene_name[i["scene_token"]] not in val_scene_names]
    val = [i for i in infos
           if scene_name[i["scene_token"]] in val_scene_names]
    for split, data in (("train", train), ("val", val)):
        path = os.path.join(out_dir,
                            f"nuscenes2d_temporal_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": data, "metadata": metadata}, f)
        paths.append(path)
    return paths
