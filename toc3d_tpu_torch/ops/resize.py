"""Bicubic resize with torch's cubic convolution (A = -0.75, edge
replication), and bilinear resize without corner alignment, as separable
weight matrices (counterpart of toc3d_tpu/ops/resize.py). The matrices are
the repo's own, copied from resize.py:16-43 and :76-110, so the port
resizes with exactly the weights the JAX package uses."""
from __future__ import annotations

import numpy as np
import torch

from .consts import device_const

_A = -0.75


def _cubic_kernel(t: np.ndarray) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (_A + 2.0) * at**3 - (_A + 3.0) * at**2 + 1.0,
        np.where(at < 2.0,
                 _A * at**3 - 5.0 * _A * at**2 + 8.0 * _A * at - 4.0 * _A,
                 0.0))


def bicubic_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic interpolation matrix."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_in / n_out
    out = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        taps = np.arange(x0 - 1, x0 + 3)
        w = _cubic_kernel(x - taps.astype(np.float64))
        for tap, wt in zip(np.clip(taps, 0, n_in - 1), w):
            out[i, tap] += wt
    return out.astype(np.float32)


def bilinear_weight_matrix(n_in: int, n_out: int,
                           align_corners: bool = False) -> np.ndarray:
    """(n_out, n_in) bilinear matrix matching torch F.interpolate."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    out = np.zeros((n_out, n_in), dtype=np.float64)
    if align_corners and n_out > 1:
        xs = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        scale = n_in / n_out
        xs = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0, None)
    for i, x in enumerate(xs):
        x0 = int(np.floor(x))
        x1 = min(x0 + 1, n_in - 1)
        f = x - x0
        out[i, x0] += 1 - f
        out[i, x1] += f
    return out.astype(np.float32)


_MATRICES = {"bicubic": bicubic_weight_matrix,
             "bilinear": bilinear_weight_matrix}


def _matrix(kind: str, n_in: int, n_out: int, device):
    return device_const((kind, n_in, n_out), device, lambda: (
        torch.from_numpy(_MATRICES[kind](n_in, n_out))))


def _resize_2d(kind: str, x, out_h: int, out_w: int):
    h, w = x.shape[-2], x.shape[-1]
    wh = _matrix(kind, h, out_h, x.device)
    ww = _matrix(kind, w, out_w, x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("pw,...ow->...op", ww, y)
    return y.to(x.dtype)


def resize_bicubic_2d(x, out_h: int, out_w: int):
    """x: (..., H, W) -> (..., out_h, out_w) in f32, cast back to x.dtype."""
    return _resize_2d("bicubic", x, out_h, out_w)


def resize_bilinear_2d(x, out_h: int, out_w: int):
    """x: (..., H, W) -> (..., out_h, out_w), torch's bilinear without
    corner alignment, in f32, cast back to x.dtype."""
    return _resize_2d("bilinear", x, out_h, out_w)


def resize_abs_pos(abs_pos, has_cls_token: bool, hw):
    """EVA abs-pos-embed resize (reference eva_utils.py:229-258).
    abs_pos: (1, num_pos, C) -> (1, H, W, C)."""
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    n = abs_pos.shape[1]
    size = int(round(float(np.sqrt(n))))
    if size * size != n:
        raise ValueError(f"position table of {n} rows is not square")
    if size == h and size == w:
        return abs_pos.reshape(1, h, w, -1)
    grid = abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2)
    grid = resize_bicubic_2d(grid, h, w)
    return grid.permute(0, 2, 3, 1)
