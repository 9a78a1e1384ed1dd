"""CPFPN neck (counterpart of toc3d_tpu/models/neck.py; reference
cp_fpn.py with in_channels=[1024], out_channels=256, num_outs=2):
out0 = conv3x3(conv1x1(x)); out1 = out0 subsampled by 2."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.nn as nn

from ..layers import conv2d


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
        if len(cfg.in_channels) != 1:
            raise ValueError("the shipped configs use one input level")
        self.lateral_convs = nn.ModuleList(
            [ConvModule(cfg.in_channels[0], cfg.out_channels, 1)])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(cfg.out_channels, cfg.out_channels, 3)])


def cpfpn_forward(neck: CPFPN, x, cfg: CPFPNConfig):
    """x (B, H, W, C_in) -> tuple of (B, H', W', out_channels)."""
    out0 = conv2d(neck.fpn_convs[0].conv,
                  conv2d(neck.lateral_convs[0].conv, x))
    outs = [out0]
    for _ in range(cfg.num_outs - 1):
        outs.append(outs[-1][:, ::2, ::2, :])
    return tuple(outs)
