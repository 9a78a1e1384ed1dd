"""Small shared blocks (counterpart of toc3d_tpu/models/common.py; reference
models/backbones/common.py: MLPBlock, FastMlp, LayerNorm2d, support code
for SAM-style backbones and the selector's 'score' aggregate).

Tensors are channel-last, as in the JAX package: LayerNorm2d normalizes the
last axis of a (B, H, W, C) map, which is what the reference's LayerNorm2d
computes over the channels of an NCHW map.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import lin, ln


class MLPBlock(nn.Module):
    """Linear -> GELU -> Linear, parameters lin1 / lin2."""

    def __init__(self, input_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(input_dim, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        return mlp_block(self, x)


def mlp_block(m: MLPBlock, x):
    """common.py:17-20, exact GELU."""
    return lin(m.lin2, F.gelu(lin(m.lin1, x)))


class FastMlp(nn.Module):
    """Linear -> GELU -> Linear, parameters fc1 / fc2, hidden
    int(embed_dim * mlp_ratio)."""

    def __init__(self, embed_dim: int, mlp_ratio: float = 4):
        super().__init__()
        hidden = int(embed_dim * mlp_ratio)
        self.fc1 = nn.Linear(embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, embed_dim)

    def forward(self, x):
        return fast_mlp(self, x)


def fast_mlp(m: FastMlp, x):
    """common.py:30-32."""
    return lin(m.fc2, F.gelu(lin(m.fc1, x)))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of a channel-last map (common.py:35-42),
    parameters weight / bias, f32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ln(self, x, self.eps)
