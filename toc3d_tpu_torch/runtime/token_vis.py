"""Token-selection visualizer: alpha-masked PNGs of kept/dropped tokens (a
copy of toc3d_tpu/runtime/token_vis.py).

Parity target: reference models/utils/token_select_vis.py:8-80
(per-view/per-layer images under <out>/<sample>/).
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..configs.presets import IMG_NORM_MEAN, IMG_NORM_STD


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized BGR -> uint8 RGB."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    out = img * std + mean
    return np.clip(out[..., ::-1], 0, 255).astype(np.uint8)


def token_selection_vis(input_imgs, masks, output_path: str,
                        patch_size: int = 16, alpha: float = 0.5):
    """input_imgs: (V, H, W, 3) normalized; masks: list per pruning layer of
    (V, h, w) or (V, h, w, 1) keep-probabilities. Writes
    <output_path>/view{v}_layer{l}.png with dropped tokens dimmed."""
    from PIL import Image

    os.makedirs(output_path, exist_ok=True)
    imgs = np.asarray(input_imgs)
    for li, mask in enumerate(masks):
        mask = np.asarray(mask)
        if mask.ndim == 4:
            mask = mask[..., 0]
        for v in range(imgs.shape[0]):
            rgb = denormalize_image(imgs[v]).astype(np.float32)
            m = np.kron(mask[v] >= 0.5,
                        np.ones((patch_size, patch_size), np.float32))
            m = m[: rgb.shape[0], : rgb.shape[1], None]
            out = rgb * (m + (1 - m) * alpha)
            Image.fromarray(out.astype(np.uint8)).save(
                os.path.join(output_path, f"view{v}_layer{li}.png"))
