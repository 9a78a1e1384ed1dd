"""ViTSimpleFPN neck: ViTDet's simple feature pyramid from one single-scale
ViT map (counterpart of toc3d_tpu/models/vit_simple_fpn.py; reference
necks/ViTsimpleFPN.py; an alternative to CPFPN, unused by the shipped
configs).

Per scale factor: 4, two 2x2 stride-2 transposed convolutions with
GroupNorm(1, C) (eps 1e-6) and GELU between them; 2, one; 1, nothing; 0.5,
a 2x2 max-pool; 0.25, a 3x3 stride-2 convolution, GroupNorm, GELU and the
max-pool. Then a 1x1 conv1 and a 3x3 conv3 to out_channels. Extra outputs
up to num_outs subsample the last by 2. No reference tree is in the repo,
so the module names are the JAX package's (stages.{i}.up1 / gn1 / up2 /
down_conv / conv1 / conv3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..layers import conv2d, conv_transpose2d
from .focal_head import group_norm

GN_EPS = 1e-6


@dataclass(frozen=True)
class ViTSimpleFPNConfig:
    in_channels: int = 1024
    out_channels: int = 256
    scale_factors: Tuple[float, ...] = (2.0, 1.0, 0.5)
    num_outs: int = 3
    start_level: int = 0


class FPNStage(nn.Module):
    def __init__(self, dim: int, out_channels: int, scale: float):
        super().__init__()
        out_dim = dim
        if scale == 4.0:
            self.up1 = nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)
            self.gn1 = nn.GroupNorm(1, dim // 2, eps=GN_EPS)
            self.up2 = nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)
            out_dim = dim // 4
        elif scale == 2.0:
            self.up1 = nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)
            out_dim = dim // 2
        elif scale == 0.25:
            self.down_conv = nn.Conv2d(dim, dim, 3, stride=2, padding=1)
            self.gn1 = nn.GroupNorm(1, dim, eps=GN_EPS)
        elif scale not in (1.0, 0.5):
            raise ValueError(f"scale factor {scale}: 4, 2, 1, 0.5 or 0.25")
        self.conv1 = nn.Conv2d(out_dim, out_channels, 1)
        self.conv3 = nn.Conv2d(out_channels, out_channels, 3, padding=1)


class ViTSimpleFPN(nn.Module):
    def __init__(self, cfg: ViTSimpleFPNConfig):
        super().__init__()
        self.cfg = cfg
        self.stages = nn.ModuleList(
            FPNStage(cfg.in_channels, cfg.out_channels, s)
            for s in cfg.scale_factors)


def _maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def vit_simple_fpn_forward(model: ViTSimpleFPN, x):
    """x (B, H, W, C) single-scale ViT features -> tuple of channel-last
    pyramid maps (vit_simple_fpn.py:65-86)."""
    cfg = model.cfg
    outs = []
    for st, scale in zip(model.stages, cfg.scale_factors):
        f = x
        if scale == 4.0:
            f = conv_transpose2d(st.up1, f)
            f = F.gelu(group_norm(st.gn1, f, GN_EPS))
            f = conv_transpose2d(st.up2, f)
        elif scale == 2.0:
            f = conv_transpose2d(st.up1, f)
        elif scale == 0.5:
            f = _maxpool2(f)
        elif scale == 0.25:
            f = F.gelu(group_norm(st.gn1, conv2d(st.down_conv, f), GN_EPS))
            f = _maxpool2(f)
        outs.append(conv2d(st.conv3, conv2d(st.conv1, f)))
    while len(outs) < cfg.num_outs:
        outs.append(outs[-1][:, ::2, ::2, :])
    return tuple(outs)[cfg.start_level:]
