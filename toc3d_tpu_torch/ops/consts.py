"""Per-frame constant tensors, built once per (key, device).

The normalisation mean and std, the bicubic resize matrices, the ranges and
grids of the selectors, the head and the decode are the same every frame.
Built from the host each time, each would be a blocking host-to-device copy
that waits for the stream (and one that a CUDA graph cannot capture); here
the first use builds the tensor and every later one reuses it, so a steady
frame copies nothing but its own inputs.
"""
from __future__ import annotations

import torch

_CONSTS: dict = {}


def device_const(key, device, build) -> torch.Tensor:
    """The tensor ``build()`` makes on the host, moved to ``device`` at the
    first call for (key, device) and kept. ``key`` must name everything the
    value depends on. The tensor is shared by every caller: read-only."""
    device = torch.device(device)
    t = _CONSTS.get((key, device))
    if t is None:
        t = build().to(device)
        # under torch.export the tensor is fake: the trace keeps it as a
        # constant of its program, and the cache never holds it
        if not torch.compiler.is_exporting():
            _CONSTS[(key, device)] = t
    return t


def const_vector(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, built once."""
    values = tuple(float(v) for v in values)
    return device_const(("vector", values, dtype), device,
                        lambda: torch.tensor(values, dtype=dtype))
