"""GridMask augmentation on the device (counterpart of
toc3d_tpu/models/grid_mask.py; reference models/utils/grid_mask.py with the
shipped GridMask(True, True, rotate=1, offset=False, ratio=0.5, mode=1,
prob=0.7), petr3d.py:61): one random grid per batch, shared by every view
and channel; mode 1 keeps the union of the stripes and zeroes the rest;
rotate=1 draws r = randint(1) = 0, so nothing rotates.

As in the JAX package the stripes come from modular arithmetic on a 1.5x
canvas offset, not from cropping a drawn canvas. The draws are explicit
tensors (``GridDraw``): apply (uniform <= prob), the period d in [2, H),
and the stripe starts st_h, st_w in [0, d) (grid_mask.py:22-29), so the
mask is computed on the device with no host read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GridDraw(NamedTuple):
    """0-d tensors: apply (bool), d, st_h, st_w (int64)."""
    apply: torch.Tensor
    d: torch.Tensor
    st_h: torch.Tensor
    st_w: torch.Tensor


def draw_grid(h: int, generator: torch.Generator, device,
              prob: float = 0.7) -> GridDraw:
    """GridMask's draws for images of height h, from ``generator``."""
    u = torch.rand((), generator=generator, device=device)
    d = torch.randint(2, h, (), generator=generator, device=device)
    st = torch.rand(2, generator=generator, device=device)
    st = (st * d).long().clamp(max=d - 1)
    return GridDraw(u <= prob, d, st[0], st[1])


def grid_mask(x, draw: GridDraw, ratio: float = 0.5):
    """x (..., H, W, C) images -> masked images (grid_mask.py:19-40)."""
    h, w = x.shape[-3], x.shape[-2]
    d = draw.d
    l = (d.float() * ratio + 0.5).long().clamp(min=1)
    l = torch.minimum(l, d - 1)
    off_h = (int(1.5 * h) - h) // 2
    off_w = (int(1.5 * w) - w) // 2
    ys = torch.arange(h, device=x.device) + off_h
    xs = torch.arange(w, device=x.device) + off_w
    stripe_y = torch.remainder(ys - draw.st_h, d) < l
    stripe_x = torch.remainder(xs - draw.st_w, d) < l
    keep = (stripe_y[:, None] | stripe_x[None, :]).to(x.dtype)[..., None]
    return torch.where(draw.apply, x * keep, x)
