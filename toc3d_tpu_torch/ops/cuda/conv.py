"""The CNN encoder's convolutions on packed weights: VoVNet's (models/
vovnet.py) and the CPFPN neck's (models/neck.py), at inference.

There is no TPU kernel behind them: JAX runs XLA's convolutions, the port
cuDNN's (F.conv2d). What the port adds is the packing. A pack holds the
weight in the activation dtype and in channels-last memory order, with a
frozen BatchNorm that follows the convolution folded in (weight x scale,
bias - mean x scale), so a frame casts no weight, computes no BatchNorm
statistic and transposes no weight: cuDNN reads channel-last maps and
channel-last weights as they lie. ``detector.precast_backbone_`` builds
every pack before a frame is captured; a pack is cached on its convolution
until its parameters (or its BatchNorm's) change.

Packs hold no autograd history: training differentiates the neck through
``layers.conv2d`` instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cached_pack, param_key


class ConvPack(NamedTuple):
    """A convolution's weight (C_out, C_in, kh, kw) in the activation dtype,
    channels-last, and its bias (C_out,) in the same dtype, or None."""
    weight: torch.Tensor
    bias: Optional[torch.Tensor]


def fold_conv(conv, norm=None):
    """(weight, bias) in float32 of ``conv`` followed by the frozen
    BatchNorm ``norm`` (the stored statistics: scale = gamma /
    sqrt(var + eps), bias = beta - mean x scale); ``conv`` alone when
    ``norm`` is None. bias None for a convolution without one and no
    norm."""
    w = conv.weight.detach().float()
    b = None if conv.bias is None else conv.bias.detach().float()
    if norm is None:
        return w, b
    scale = norm.weight.detach().float() * torch.rsqrt(
        norm.running_var.detach().float() + norm.eps)
    shift = norm.bias.detach().float() - \
        norm.running_mean.detach().float() * scale
    if b is not None:
        shift = shift + b * scale
    return w * scale[:, None, None, None], shift


def pack_conv(conv, dtype, norm=None) -> ConvPack:
    """The pack of ``conv`` (and the frozen BatchNorm ``norm`` after it) in
    ``dtype``, cached on ``conv`` until its or the norm's parameters
    change."""
    def build():
        w, b = fold_conv(conv, norm)
        return ConvPack(
            w.to(dtype).contiguous(memory_format=torch.channels_last),
            None if b is None else b.to(dtype).contiguous())
    extra = () if norm is None else (param_key(norm),)
    return cached_pack(conv, "conv", param_key(conv, dtype, *extra), build)


def conv2d(x, pack: ConvPack, stride, padding, relu: bool = False):
    """Channel-last convolution: x (B, H, W, C_in) -> (B, H', W', C_out) in
    x's dtype, + the pack's bias, then ReLU when ``relu``. On the card one
    cuDNN call, counted in ``launches``: with ``relu`` cuDNN's fused
    convolution, bias and activation (torch.cudnn_convolution_relu, the
    bias added in f32 before the one rounding), else F.conv2d (its bias a
    separate add). On the CPU the plain F.conv2d, then F.relu. The NCHW
    view of x keeps its channels-last strides, which the convolution keeps,
    so neither permute copies."""
    xs = x.permute(0, 3, 1, 2)
    if x.is_cuda and relu:
        y = torch.cudnn_convolution_relu(xs, pack.weight, pack.bias, stride,
                                         padding, (1, 1), 1)
    else:
        y = F.conv2d(xs, pack.weight, pack.bias, stride=stride,
                     padding=padding)
        if relu:
            y = F.relu(y)
    if x.is_cuda:
        conv2d.launches += 1
    return y.permute(0, 2, 3, 1)


conv2d.launches = 0


def packed_conv2d(conv, x, norm=None, relu: bool = False):
    """``conv`` (and the frozen BatchNorm ``norm`` after it, then ReLU when
    ``relu``) on the channel-last x through its pack in x's dtype."""
    return conv2d(x, pack_conv(conv, x.dtype, norm), conv.stride,
                  conv.padding, relu)
