"""Functional building blocks (counterpart of toc3d_tpu/layers.py).

Conventions, as in the JAX package:
* ``linear`` casts the weight and bias to the activation dtype, so a bf16
  activation runs a bf16 product and an f32 activation an f32 one
  (layers.py:81-88). Weights are torch ``nn.Linear`` layout ``(out, in)``.
* LayerNorm computes its statistics in float32 and casts back to the input
  dtype (layers.py:134-142).
* int8 serving (layers.py:81-121): ``quantize_linear`` packs a weight per
  output channel into a ``QuantLinear``; ``linear`` given such a pack takes
  the int8 route (ops/cuda/int8.int8_linear: kernel H8 on the card, one
  launch that quantizes the rows dynamically and runs the int8 product; its
  plain version on the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops.cuda import cached_pack, param_key
from .ops.cuda.int8 import QuantLinear, int8_linear, quantize_weight


def linear(x, weight, bias=None):
    """x @ weight.T + bias, with weight and bias cast to x's dtype; or, when
    ``weight`` is a QuantLinear (which carries its own bias), the int8
    linear."""
    if isinstance(weight, QuantLinear):
        return int8_linear(x, weight)
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, weight.to(x.dtype), b)


def quantize_linear(weight, bias=None) -> QuantLinear:
    """Symmetric per-output-channel int8 quantization of one linear
    (layers.py:91-107): int8 (out, in) weight, f32 (out,) scale; the bias
    stays f32."""
    w, s = quantize_weight(weight)
    return QuantLinear(w, s, None if bias is None
                       else bias.detach().float().contiguous())


def quantized(mod: nn.Linear) -> QuantLinear:
    """The int8 pack of ``mod``, cached on the module until its parameters
    change."""
    return cached_pack(mod, "int8", param_key(mod),
                       lambda: quantize_linear(mod.weight, mod.bias))


def lin(mod: nn.Linear, x, quant: str = "none"):
    if quant == "int8":
        return linear(x, quantized(mod))
    return linear(x, mod.weight, mod.bias)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """Two-pass f32 statistics (mean, then mean of squared deviations)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(dt)


def ln(mod: Optional[nn.LayerNorm], x, eps: float = 1e-6):
    if mod is None:
        return layer_norm(x, eps=eps)
    return layer_norm(x, mod.weight, mod.bias, eps)


def swiglu(x, w1: nn.Linear, w2: nn.Linear, w3: nn.Linear,
           ffn_ln: Optional[nn.LayerNorm], ln_eps: float = 1e-6):
    """silu(x w1) * (x w2) -> sub-LN -> w3 (layers.py:258-264)."""
    hidden = F.silu(lin(w1, x)) * lin(w2, x)
    if ffn_ln is not None:
        hidden = ln(ffn_ln, hidden, ln_eps)
    return lin(w3, hidden)


def conv2d(mod: nn.Conv2d, x):
    """Channel-last convolution of x (B, H, W, C) by ``mod`` with its own
    stride and padding, in x's dtype (layers.py:179-189: weight and bias
    cast to x's dtype). The NCHW view of x keeps the channels-last strides,
    which the convolution keeps, so neither permute copies."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), mod.weight.to(x.dtype), b,
                 stride=mod.stride, padding=mod.padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(mod: nn.ConvTranspose2d, x):
    """Channel-last transposed convolution (layers.py:201-208), in x's
    dtype."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), mod.weight.to(x.dtype), b,
                           stride=mod.stride)
    return y.permute(0, 2, 3, 1)


def mlp_relu(layers, x):
    """Linear -> ReLU -> ... -> Linear over the Linear modules of
    ``layers`` (an nn.Sequential whose odd slots hold the activations)."""
    mods = [m for m in layers if isinstance(m, nn.Linear)]
    for i, m in enumerate(mods):
        x = lin(m, x)
        if i < len(mods) - 1:
            x = F.relu(x)
    return x


class MLN(nn.Module):
    """Meta LayerNorm: affine parameters predicted from a condition vector
    (layers.py:271-286; reference misc.py:154-188). Parameter names follow
    the reference: reduce.0, gamma, beta."""

    def __init__(self, c_dim: int, f_dim: int = 256):
        super().__init__()
        self.reduce = nn.Sequential(nn.Linear(c_dim, f_dim), nn.ReLU())
        self.gamma = nn.Linear(f_dim, f_dim)
        self.beta = nn.Linear(f_dim, f_dim)

    def forward(self, x, c, eps: float = 1e-5):
        return mln(self, x, c, eps)


def mln(m: MLN, x, c, eps: float = 1e-5):
    x = layer_norm(x, eps=eps)
    c = F.relu(lin(m.reduce[0], c))
    return lin(m.gamma, c) * x + lin(m.beta, c)


class SELinear(nn.Module):
    """Featurized positional-encoding gate (layers.py:293-304; reference
    misc.py:139-151 SELayer_Linear)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = nn.Linear(channels, channels)
        self.conv_expand = nn.Linear(channels, channels)

    def forward(self, x, x_se):
        return se_linear(self, x, x_se)


def se_linear(m: SELinear, x, x_se):
    g = F.relu(lin(m.conv_reduce, x_se))
    g = lin(m.conv_expand, g)
    return x * torch.sigmoid(g)


def inverse_sigmoid(x, eps: float = 1e-5):
    """log(x / (1 - x)) with both sides clipped at eps (layers.py:311-315)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def bias_init_with_prob(prior_prob: float) -> float:
    import math
    return float(-math.log((1 - prior_prob) / prior_prob))
