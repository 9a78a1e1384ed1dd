"""3D box math (counterpart of toc3d_tpu/core/boxes.py; reference
core/bbox/util.py:3-51, misc.py:191-200): the decoder's code on tensors,
and the host-side numpy LiDAR box helpers the training augmentations use
(boxes.py:76-135; mmdet3d lidar_box3d.py, base_box3d.py).

10-dim code: [cx, cy, cz, log w, log l, log h, sin yaw, cos yaw, vx, vy].
Box layout (mmdet3d LiDAR, box_dim 9): [x, y, z, w, l, h, yaw, vx, vy].
"""
from __future__ import annotations

import numpy as np
import torch


def normalize_bbox(bboxes):
    """(..., >=7) gravity-center boxes -> (..., 8 or 10) code."""
    parts = [bboxes[..., 0:3], bboxes[..., 3:6].log(),
             bboxes[..., 6:7].sin(), bboxes[..., 6:7].cos()]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def denormalize_bbox(code):
    """(..., 8 or 10) code -> (..., 7 or 9) gravity-center boxes."""
    rot = torch.atan2(code[..., 6:7], code[..., 7:8])
    parts = [code[..., 0:3], code[..., 3:6].exp(), rot]
    if code.shape[-1] > 8:
        parts.append(code[..., 8:10])
    return torch.cat(parts, dim=-1)


def transform_reference_points(reference_points, egopose):
    """(B, N, 3) points through (B, 4, 4) poses -> (B, N, 3)."""
    pts = torch.cat([reference_points,
                     torch.ones_like(reference_points[..., :1])], dim=-1)
    return torch.einsum("bij,bnj->bni", egopose, pts)[..., :3]


def gravity_center(boxes: np.ndarray) -> np.ndarray:
    """(N, >=7) bottom-center boxes -> (N, 3) gravity centers
    (boxes.py:67-71)."""
    out = boxes[:, :3].copy()
    out[:, 2] = boxes[:, 2] + boxes[:, 5] * 0.5
    return out


def boxes_with_gravity_center(boxes: np.ndarray) -> np.ndarray:
    """(N, D) bottom-center boxes -> (N, D) with the center z, the loss and
    assignment target layout (boxes.py:74-79)."""
    out = boxes.copy()
    out[:, 2] = boxes[:, 2] + boxes[:, 5] * 0.5
    return out


def flip_boxes(boxes: np.ndarray, direction="horizontal") -> np.ndarray:
    """Flip in BEV (lidar_box3d.py:143-166): 'horizontal' mirrors y and the
    yaw, 'vertical' mirrors x and takes pi - yaw; velocities follow."""
    out = boxes.copy()
    if direction == "horizontal":
        out[:, 1] = -boxes[:, 1]
        out[:, 6] = -boxes[:, 6]
        if boxes.shape[1] == 9:
            out[:, 8] = -boxes[:, 8]
    elif direction == "vertical":
        out[:, 0] = -boxes[:, 0]
        out[:, 6] = -boxes[:, 6] + np.pi
        if boxes.shape[1] == 9:
            out[:, 7] = -boxes[:, 7]
    return out


def rotate_boxes_z(boxes: np.ndarray, angle: float) -> np.ndarray:
    """Rotate LiDAR boxes around z by ``angle`` (lidar_box3d.py:91-141)."""
    rot_sin, rot_cos = np.sin(angle), np.cos(angle)
    rot = np.array([[rot_cos, rot_sin, 0],
                    [-rot_sin, rot_cos, 0],
                    [0, 0, 1]], dtype=boxes.dtype)
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ rot
    out[:, 6] = boxes[:, 6] + angle
    if boxes.shape[1] == 9:
        out[:, 7:9] = boxes[:, 7:9] @ rot[:2, :2]
    return out


def scale_boxes(boxes: np.ndarray, scale: float) -> np.ndarray:
    """Scale position, size and velocity (base_box3d.py:263)."""
    out = boxes.copy()
    out[:, :6] = boxes[:, :6] * scale
    if boxes.shape[1] == 9:
        out[:, 7:9] = boxes[:, 7:9] * scale
    return out


def translate_boxes(boxes: np.ndarray, trans) -> np.ndarray:
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] + np.asarray(trans, boxes.dtype)
    return out


def in_range_bev(boxes: np.ndarray, bev_range) -> np.ndarray:
    """(N,) bool, mmdet3d in_range_bev: x1 < x < x2 and y1 < y < y2."""
    return ((boxes[:, 0] > bev_range[0]) & (boxes[:, 1] > bev_range[1])
            & (boxes[:, 0] < bev_range[2]) & (boxes[:, 1] < bev_range[3]))


def limit_yaw(boxes: np.ndarray, offset=0.5, period=np.pi * 2) -> np.ndarray:
    out = boxes.copy()
    out[:, 6] = boxes[:, 6] - np.floor(boxes[:, 6] / period + offset) * period
    return out
