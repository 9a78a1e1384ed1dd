"""Samplers and GT padding (counterpart of toc3d_tpu/data/sampler.py).

  InfiniteGroupEachSampleInBatchSampler -> reference
      datasets/samplers/group_sampler.py:153-236: every batch lane streams
      one scene (split) at a time, in order, and only the order of the
      groups is shuffled, so the head's memory bank stays valid from one
      training iteration to the next.
  contiguous_eval_chunks -> reference datasets/samplers/
      distributed_sampler.py:15-47: each rank gets one contiguous chunk, so
      scenes stay (mostly) whole and the global order holds when the ranks'
      results are joined.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Sequence

import numpy as np


class InfiniteGroupEachSampleInBatchSampler:
    """Yields lists of ``batch_size`` dataset indices; lane i streams its
    own sequence of groups, in order within each group
    (sampler.py:21-65)."""

    def __init__(self, flags: np.ndarray, batch_size: int,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.group_sizes = np.bincount(self.flags)
        self.groups_num = len(self.group_sizes)
        self.global_batch_size = batch_size * num_replicas
        if self.groups_num < self.global_batch_size:
            raise ValueError("need at least one group per global batch lane")
        self.group_idx_to_sample_idxs = {
            g: np.where(self.flags == g)[0].tolist()
            for g in range(self.groups_num)}
        self._lane_group_iters = [
            self._group_indices_for_lane(rank * batch_size + i)
            for i in range(batch_size)]
        self._buffers: List[List[int]] = [[] for _ in range(batch_size)]

    def _infinite_group_indices(self):
        rng = np.random.RandomState(self.seed)
        while True:
            yield from rng.permutation(self.groups_num).tolist()

    def _group_indices_for_lane(self, global_lane: int):
        yield from itertools.islice(self._infinite_group_indices(),
                                    global_lane, None,
                                    self.global_batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            batch = []
            for lane in range(self.batch_size):
                if not self._buffers[lane]:
                    g = next(self._lane_group_iters[lane])
                    self._buffers[lane] = list(
                        self.group_idx_to_sample_idxs[g])
                batch.append(self._buffers[lane].pop(0))
            yield batch


def contiguous_eval_chunks(n_samples: int, num_replicas: int,
                           rank: int) -> List[int]:
    """Sequential eval split: rank r gets samples [r*chunk, (r+1)*chunk)
    (distributed_sampler.py:30-47); last rank absorbs the remainder."""
    chunk = int(np.ceil(n_samples / num_replicas))
    start = rank * chunk
    return list(range(start, min(start + chunk, n_samples)))


def pad_gt_3d(boxes: np.ndarray, labels: np.ndarray, max_gt: int):
    """(G, 9) bottom-z boxes, (G,) labels -> padded (max_gt, 9) gravity-z
    boxes, (max_gt,) labels, (max_gt,) valid mask (the loss's GT layout,
    streampetr_head.py:982-984)."""
    g = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, 9), np.float32)
    out_l = np.zeros((max_gt,), np.int64)
    out_v = np.zeros((max_gt,), bool)
    if g:
        b = boxes[:g].astype(np.float32).copy()
        b[:, 2] += b[:, 5] * 0.5               # bottom -> gravity z
        out_b[:g] = b
        out_l[:g] = labels[:g]
        out_v[:g] = True
    return out_b, out_l, out_v


def pad_gt_2d(bboxes: Sequence[np.ndarray], labels: Sequence[np.ndarray],
              centers: Sequence[np.ndarray], max_gt: int):
    """Per-view lists -> padded (V, max_gt, ...) arrays and a valid mask."""
    v = len(bboxes)
    out_b = np.zeros((v, max_gt, 4), np.float32)
    out_l = np.zeros((v, max_gt), np.int64)
    out_c = np.zeros((v, max_gt, 2), np.float32)
    out_v = np.zeros((v, max_gt), bool)
    for i in range(v):
        g = min(len(bboxes[i]), max_gt)
        if g:
            out_b[i, :g] = bboxes[i][:g]
            out_l[i, :g] = labels[i][:g]
            out_c[i, :g] = centers[i][:g]
            out_v[i, :g] = True
    return out_b, out_l, out_c, out_v


def collate_batch(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts of numpy arrays into a batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
