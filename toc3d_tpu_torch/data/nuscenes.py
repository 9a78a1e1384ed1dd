"""nuScenes temporal infos and the image preprocessing (counterpart of
toc3d_tpu/data/nuscenes.py: the pose math :32-61, AugConfig :63-74,
NuScenesInfos :77-188, sample_augmentation :189, ida_matrix :214,
transform_image :230, normalize_image :246, pad_to_multiple :253, and the
train-time augmentations transform_boxes2d :275, filter_invisible :300 and
global_rot_scale_trans :318; the reference's
datasets/nuscenes_dataset.py:165-258 and pipelines/transform_3d.py).

Host-side numpy and PIL, as in the JAX package; PIL is imported where an
image is resized. Timestamps are float32 seconds relative to the first
sample of the run.
"""
from __future__ import annotations

import math
import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..configs.presets import CLASS_NAMES, IMG_NORM_MEAN, IMG_NORM_STD


def quaternion_rotation_matrix(q) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix (pyquaternion convention)."""
    w, x, y, z = [float(v) for v in q]
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def pose_matrix(rotation, translation) -> np.ndarray:
    m = np.zeros((4, 4), np.float32)
    m[:3, :3] = rotation
    m[:3, 3] = translation
    m[3, 3] = 1.0
    return m


def invert_pose(m) -> np.ndarray:
    r = m[:3, :3]
    t = m[:3, 3]
    out = np.zeros((4, 4), np.float32)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    out[3, 3] = 1.0
    return out


@dataclass
class AugConfig:
    """ida_aug_conf knobs (ToC3D_fast.py:175-183)."""
    resize_lim: Tuple[float, float] = (0.47, 0.625)
    final_dim: Tuple[int, int] = (320, 800)     # (fH, fW)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    H: int = 900
    W: int = 1600
    rand_flip: bool = True


AUG_800x320 = AugConfig()
AUG_1600x800 = AugConfig(resize_lim=(0.94, 1.25), final_dim=(800, 1600))


class NuScenesInfos:
    """Loads nuscenes2d_temporal_infos_{train,val}.pkl and exposes frames."""

    def __init__(self, ann_file: str, seq_split_num: int = 1,
                 use_valid_flag: bool = True):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        self.metadata = data.get("metadata", {})
        self.version = self.metadata.get("version", "v1.0-trainval")
        # mmdet3d sorts by timestamp (load_annotations)
        self.infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.use_valid_flag = use_valid_flag
        self.flag = self._sequence_flags(seq_split_num)
        self.t0 = self.infos[0]["timestamp"] / 1e6 if self.infos else 0.0

    def __len__(self):
        return len(self.infos)

    def _sequence_flags(self, seq_split_num) -> np.ndarray:
        """Per-scene group ids, sub-split for streaming training
        (nuscenes_dataset.py:60-96; seq_split_num='all' makes every sample
        its own group)."""
        res, cur = [], 0
        for idx, info in enumerate(self.infos):
            if idx != 0 and len(info["sweeps"]) == 0:
                cur += 1
            res.append(cur)
        flag = np.array(res, np.int64)
        if seq_split_num == "all":
            return np.arange(len(self.infos), dtype=np.int64)
        if seq_split_num == 1:
            return flag
        bin_counts = np.bincount(flag)
        new_flags, cur = [], 0
        for b in bin_counts:
            bounds = list(range(0, b, math.ceil(b / seq_split_num))) + [b]
            for n in np.diff(bounds):
                new_flags.extend([cur] * n)
                cur += 1
        return np.array(new_flags, np.int64)

    def frame_meta(self, index: int) -> Dict:
        """Pose/calibration/meta for one sample (no image IO)."""
        info = self.infos[index]
        e2g = pose_matrix(
            quaternion_rotation_matrix(info["ego2global_rotation"]),
            info["ego2global_translation"])
        l2e = pose_matrix(
            quaternion_rotation_matrix(info["lidar2ego_rotation"]),
            info["lidar2ego_translation"])
        ego_pose = (e2g @ l2e).astype(np.float32)       # lidar2global
        meta = {
            "token": info["token"],
            "scene_token": info["scene_token"],
            "timestamp": info["timestamp"] / 1e6 - self.t0,
            "abs_timestamp": info["timestamp"] / 1e6,
            "ego_pose": ego_pose,
            "ego_pose_inv": invert_pose(ego_pose),
            "img_paths": [],
            "intrinsics": [],
            "extrinsics": [],
        }
        for cam_type, cam in info["cams"].items():
            c2l = pose_matrix(cam["sensor2lidar_rotation"],
                              cam["sensor2lidar_translation"])
            l2c = invert_pose(c2l)
            viewpad = np.eye(4, dtype=np.float64)
            intr = np.asarray(cam["cam_intrinsic"])
            viewpad[: intr.shape[0], : intr.shape[1]] = intr
            meta["img_paths"].append(cam["data_path"])
            meta["intrinsics"].append(viewpad)
            meta["extrinsics"].append(l2c.astype(np.float64))
        return meta

    def annotations(self, index: int) -> Dict:
        """3D + 2D GT for one sample (train / labeled eval).

        3D boxes are returned bottom-z (LiDAR convention): the info pkl
        stores gravity-z which mmdet3d shifts via origin=(.5,.5,.5)."""
        info = self.infos[index]
        mask = (info["valid_flag"] if self.use_valid_flag
                else info["num_lidar_pts"] > 0)
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)[mask]
        velocity = np.asarray(info["gt_velocity"], np.float32).reshape(
            -1, 2)[mask]
        velocity = np.nan_to_num(velocity)
        names = np.asarray(info["gt_names"])[mask]
        labels = np.array([CLASS_NAMES.index(n) if n in CLASS_NAMES else -1
                           for n in names], np.int64)
        boxes = np.concatenate([boxes, velocity], axis=-1)
        boxes[:, 2] -= boxes[:, 5] * 0.5                 # gravity -> bottom z
        return {
            "gt_bboxes_3d": boxes,                       # (G, 9) bottom-z
            "gt_labels_3d": labels,
            "bboxes2d": [np.asarray(b, np.float32).reshape(-1, 4)
                         for b in info["bboxes2d"]],
            "labels2d": [np.asarray(l, np.int64).reshape(-1)
                         for l in info["labels2d"]],
            "centers2d": [np.asarray(c, np.float32).reshape(-1, 2)
                          for c in info["centers2d"]],
            "depths": [np.asarray(d, np.float32).reshape(-1)
                       for d in info["depths"]],
        }

    def prev_exists(self, index: int) -> bool:
        return not (index == 0 or self.flag[index - 1] != self.flag[index])


# ---------------------------------------------------------------------------
# image transforms
# ---------------------------------------------------------------------------

def sample_augmentation(aug: AugConfig, training: bool,
                        rng: Optional[np.random.RandomState] = None):
    """(transform_3d.py:275-298)."""
    h, w = aug.H, aug.W
    fh, fw = aug.final_dim
    if training:
        assert rng is not None
        resize = rng.uniform(*aug.resize_lim)
        resize_dims = (int(w * resize), int(h * resize))
        new_w, new_h = resize_dims
        crop_h = int((1 - rng.uniform(*aug.bot_pct_lim)) * new_h) - fh
        crop_w = int(rng.uniform(0, max(0, new_w - fw)))
        crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        flip = bool(aug.rand_flip and rng.choice([0, 1]))
    else:
        resize = max(fh / h, fw / w)
        resize_dims = (int(w * resize), int(h * resize))
        new_w, new_h = resize_dims
        crop_h = int((1 - np.mean(aug.bot_pct_lim)) * new_h) - fh
        crop_w = int(max(0, new_w - fw) / 2)
        crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        flip = False
    return resize, resize_dims, crop, flip


def ida_matrix(resize: float, crop, flip: bool) -> np.ndarray:
    """Image-domain-augmentation homography (transform_3d.py:247-273,
    rotate==0 in all shipped configs)."""
    rot = np.eye(2, dtype=np.float64) * resize
    tran = -np.asarray(crop[:2], np.float64)
    if flip:
        a = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop[2] - crop[0], 0.0])
        rot = a @ rot
        tran = a @ tran + b
    m = np.eye(3, dtype=np.float64)
    m[:2, :2] = rot
    m[:2, 2] = tran
    return m


def transform_image(img: np.ndarray, resize_dims, crop, flip: bool):
    """img: (H, W, 3) uint8 BGR -> cropped (fH, fW, 3) float32 BGR.

    PIL bilinear resize + crop, matching Image.resize / Image.crop defaults
    used by the reference."""
    from PIL import Image

    pil = Image.fromarray(img[..., ::-1])                # PIL works in RGB
    pil = pil.resize(resize_dims)
    pil = pil.crop(crop)
    if flip:
        pil = pil.transpose(method=Image.FLIP_LEFT_RIGHT)
    out = np.asarray(pil, np.float32)[..., ::-1]         # back to BGR
    return np.ascontiguousarray(out)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """BGR mean/std normalization (to_rgb=False, ToC3D_fast.py:13-14)."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    return (img - mean) / std


def pad_to_multiple(img: np.ndarray, divisor: int = 32,
                    fill=None) -> np.ndarray:
    """Bottom/right-pad to a multiple of `divisor`. fill: per-channel pad
    value (default 0). uint8 frames destined for DEVICE-side normalization
    must pad with the (rounded) mean pixel so (pad-mean)/std lands ~0 like
    the host-normalized path's exact 0.0 (ADVICE r4: zero-padded uint8
    became (0-mean)/std ≈ -2 on device whenever final_dim wasn't already a
    32-multiple)."""
    h, w = img.shape[:2]
    ph = (divisor - h % divisor) % divisor
    pw = (divisor - w % divisor) % divisor
    if ph or pw:
        if fill is None:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        else:
            out = np.empty((h + ph, w + pw) + img.shape[2:], img.dtype)
            out[...] = np.asarray(fill, img.dtype)
            out[:h, :w] = img
            img = out
    return img


def transform_boxes2d(bboxes, centers2d, labels, depths, resize, crop, flip,
                      final_dim, min_size=2.0):
    """Resize, crop and flip the 2D GT with the image, dropping boxes under
    min_size (transform_3d.py:174-208)."""
    fh, fw = final_dim
    bboxes = bboxes * resize
    bboxes[:, [0, 2]] -= crop[0]
    bboxes[:, [1, 3]] -= crop[1]
    bboxes[:, [0, 2]] = np.clip(bboxes[:, [0, 2]], 0, fw)
    bboxes[:, [1, 3]] = np.clip(bboxes[:, [1, 3]], 0, fh)
    keep = ((bboxes[:, 2] - bboxes[:, 0]) >= min_size) & (
        (bboxes[:, 3] - bboxes[:, 1]) >= min_size)
    if flip:
        x0, x1 = bboxes[:, 0].copy(), bboxes[:, 2].copy()
        bboxes[:, 2] = fw - x0
        bboxes[:, 0] = fw - x1
    bboxes = bboxes[keep]
    centers2d = centers2d * resize
    centers2d[:, 0] = np.clip(centers2d[:, 0] - crop[0], 0, fw)
    centers2d[:, 1] = np.clip(centers2d[:, 1] - crop[1], 0, fh)
    if flip:
        centers2d[:, 0] = fw - centers2d[:, 0]
    return bboxes, centers2d[keep], labels[keep], depths[keep]


def filter_invisible(bboxes, centers2d, labels, depths, final_dim):
    """Depth-sorted occlusion filter (transform_3d.py:211-235): paint the
    boxes far to near and keep those still visible."""
    fh, fw = final_dim
    idx_map = np.zeros((fh, fw), np.int64)
    tmp = np.zeros_like(bboxes)
    tmp[:, :2] = np.ceil(bboxes[:, :2])
    tmp[:, 2:] = np.floor(bboxes[:, 2:])
    tmp = tmp.astype(np.int64)
    order = np.argsort(-depths, axis=0, kind="stable")
    tmp, bboxes = tmp[order], bboxes[order]
    depths, centers2d, labels = depths[order], centers2d[order], labels[order]
    for i in range(bboxes.shape[0]):
        u1, v1, u2, v2 = tmp[i]
        idx_map[v1:v2, u1:u2] = i
    vis = np.unique(idx_map).astype(np.int64)
    return bboxes[vis], centers2d[vis], labels[vis], depths[vis]


def global_rot_scale_trans(meta, gt_boxes, rng,
                           rot_range=(-0.3925, 0.3925),
                           scale_ratio_range=(0.95, 1.05),
                           translation_std=(0, 0, 0)):
    """BEV rotation, scale and translation of lidar2img, ego_pose (and its
    inverse) and the 3D boxes (transform_3d.py:300-385,
    reverse_angle=True)."""
    from ..core.boxes import rotate_boxes_z, scale_boxes, translate_boxes
    angle = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_ratio_range)
    trans = rng.normal(scale=np.asarray(translation_std, np.float64), size=3)

    def rot_mat(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0, 0], [-s, c, 0, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)

    mats = [rot_mat(angle),
            np.diag([scale, scale, scale, 1.0]),
            np.block([[np.eye(3), np.asarray(trans)[:, None]],
                      [np.zeros((1, 3)), np.ones((1, 1))]])]
    for m in mats:
        m_inv = np.linalg.inv(m)
        meta["lidar2img"] = [l @ m_inv for l in meta["lidar2img"]]
        meta["ego_pose"] = meta["ego_pose"] @ m_inv
        meta["ego_pose_inv"] = m @ meta["ego_pose_inv"]
    gt_boxes = rotate_boxes_z(gt_boxes, -angle)  # reverse_angle=True
    gt_boxes = scale_boxes(gt_boxes, scale)
    gt_boxes = translate_boxes(gt_boxes, trans)
    return meta, gt_boxes
