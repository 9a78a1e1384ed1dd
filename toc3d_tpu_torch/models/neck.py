"""CPFPN neck (counterpart of toc3d_tpu/models/neck.py; reference
cp_fpn.py). One lateral 1x1 convolution an input level (with bias); a
top-down pass that adds each level's lateral, nearest-upsampled to the
size of the level below, into that level's; one 3x3 convolution (with
bias), on level 0 only: the other levels pass their summed laterals
through (the CP in CPFPN keeps only level 0's fpn convolution); then
extra outputs up to num_outs, each the last one subsampled by 2.

The ViT configurations give one level (in_channels=[1024]): out0 =
conv3x3(conv1x1(x)), out1 = out0 subsampled by 2. StreamPETR's V2-99
gives two (VoVNet's stage4 and stage5, [768, 1024]): out0 =
conv3x3(lat0 + up(lat1)), out1 = lat1.

At inference the convolutions run on packed weights (ops/cuda/conv,
built by detector.precast_backbone_); training differentiates them
through layers.conv2d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..layers import conv2d
from ..ops.cuda.conv import pack_conv, packed_conv2d


@dataclass(frozen=True)
class CPFPNConfig:
    in_channels: Tuple[int, ...] = (1024,)
    out_channels: int = 256
    num_outs: int = 2


class ConvModule(nn.Module):
    """mmcv ConvModule with no norm and no activation: just ``conv``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


class CPFPN(nn.Module):
    def __init__(self, cfg: CPFPNConfig):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, cfg.out_channels, 1) for c in cfg.in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(cfg.out_channels, cfg.out_channels, 3)])


def pack_cpfpn(neck: CPFPN, dtype) -> None:
    """Build the packs of every convolution of ``neck`` in ``dtype``
    (ops/cuda/conv.pack_conv)."""
    for m in list(neck.lateral_convs) + list(neck.fpn_convs):
        pack_conv(m.conv, dtype)


def upsample_nearest(x, size):
    """F.interpolate(mode='nearest') of a channel-last map to ``size``."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                         mode="nearest").permute(0, 2, 3, 1)


def cpfpn_forward(neck: CPFPN, xs, cfg: CPFPNConfig, train: bool = False):
    """xs: one (B, H_i, W_i, C_i) map an input level, finest first (or the
    one map of a one-level config) -> tuple of num_outs (B, H', W',
    out_channels) maps. train: differentiate the convolutions (per-call
    casts) instead of running their packs."""
    conv = conv2d if train else packed_conv2d
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    if len(xs) != len(cfg.in_channels):
        raise ValueError(f"CPFPN: {len(xs)} input levels for in_channels "
                         f"{cfg.in_channels}")
    lats = [conv(m.conv, x) for m, x in zip(neck.lateral_convs, xs)]
    for i in range(len(lats) - 1, 0, -1):
        lats[i - 1] = lats[i - 1] + upsample_nearest(lats[i],
                                                     lats[i - 1].shape[1:3])
    outs = [conv(neck.fpn_convs[0].conv, lats[0])] + lats[1:]
    for _ in range(cfg.num_outs - len(outs)):
        outs.append(outs[-1][:, ::2, ::2, :])
    return tuple(outs)
