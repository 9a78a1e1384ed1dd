"""Bicubic resize with torch's cubic convolution (A = -0.75, edge
replication) as separable weight matrices (counterpart of
toc3d_tpu/ops/resize.py). The matrices are the repo's own, copied from
resize.py:16-43, so the port resizes the position embedding with exactly the
weights the JAX package uses."""
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


def _matrix(n_in: int, n_out: int, device):
    return device_const(("bicubic", n_in, n_out), device, lambda: (
        torch.from_numpy(bicubic_weight_matrix(n_in, n_out))))


def resize_bicubic_2d(x, out_h: int, out_w: int):
    """x: (..., H, W) -> (..., out_h, out_w) in f32, cast back to x.dtype."""
    h, w = x.shape[-2], x.shape[-1]
    wh = _matrix(h, out_h, x.device)
    ww = _matrix(w, out_w, x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("pw,...ow->...op", ww, y)
    return y.to(x.dtype)


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
