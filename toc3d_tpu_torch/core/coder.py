"""NMS-free box decoding (counterpart of toc3d_tpu/core/coder.py; reference
nms_free_coder.py:39-111): top max_num over query x class, a fixed number of
boxes plus a validity mask from the post-center range."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.consts import const_vector
from .boxes import denormalize_bbox


class DecodedBoxes(NamedTuple):
    bboxes: torch.Tensor   # (B, max_num, 9)
    scores: torch.Tensor   # (B, max_num)
    labels: torch.Tensor   # (B, max_num) int64
    valid: torch.Tensor    # (B, max_num) bool


def nms_free_decode(all_cls_scores, all_bbox_preds, num_classes: int,
                    max_num: int, post_center_range) -> DecodedBoxes:
    """all_cls_scores (L, B, Q, classes) logits; all_bbox_preds
    (L, B, Q, 10) with unnormalized centers; decodes the last layer."""
    cls = torch.sigmoid(all_cls_scores[-1])
    box = all_bbox_preds[-1]
    b, q, c = cls.shape
    scores, idx = cls.reshape(b, q * c).topk(max_num, dim=1)
    labels = idx % num_classes
    bidx = idx // num_classes
    box = torch.gather(box, 1, bidx[..., None].expand(-1, -1, box.shape[-1]))
    final = denormalize_bbox(box)
    pcr = const_vector(post_center_range, final.dtype, final.device)
    valid = ((final[..., :3] >= pcr[:3]).all(dim=-1)
             & (final[..., :3] <= pcr[3:]).all(dim=-1))
    return DecodedBoxes(final, scores, labels, valid)


def to_bottom_center(bboxes):
    """Gravity-center z -> bottom-center z (z -= h / 2)."""
    z = bboxes[..., 2:3] - bboxes[..., 5:6] * 0.5
    return torch.cat([bboxes[..., :2], z, bboxes[..., 3:]], dim=-1)
