"""The streaming detector's inter-frame state (counterpart of
toc3d_tpu/models/streampetr_head.py :: MemoryBank and
toc3d_tpu/models/detector.py :: DetectorState). Kept apart from the model
modules so that a served artifact (runtime/export.load_detector) returns
the same types without importing any model code."""
from __future__ import annotations

from typing import NamedTuple

import torch


class MemoryBank(NamedTuple):
    """Temporal query memory: memory_len slots of (embedding, reference
    point, relative timestamp, 4x4 ego pose, velocity), global frame."""
    embedding: torch.Tensor        # (B, L, C)
    reference_point: torch.Tensor  # (B, L, 3)
    timestamp: torch.Tensor        # (B, L, 1)
    egopose: torch.Tensor          # (B, L, 4, 4)
    velo: torch.Tensor             # (B, L, 2)


class DetectorState(NamedTuple):
    memory: MemoryBank


def is_steady(frame) -> bool:
    """all(prev_exists > 0): whether every lane continues its scene, so the
    selectors skip the first-frame score MLP. JAX decides this on the
    device (lax.cond, token_select.py:227); here the host decides, reading
    the frame's prev_exists where it lies: a numpy array or a host tensor
    costs no device read, a device tensor one."""
    return bool((frame["prev_exists"] > 0).all())
