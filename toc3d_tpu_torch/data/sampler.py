"""The eval sampler (counterpart of toc3d_tpu/data/sampler.py ::
contiguous_eval_chunks, :67; the reference's eval DistributedSampler,
datasets/samplers/distributed_sampler.py:15-47): each rank gets one
contiguous chunk, so scenes stay (mostly) whole and the global order holds
when the ranks' results are joined. The training samplers and the GT
padding belong to the training slice.
"""
from __future__ import annotations

from typing import List

import numpy as np


def contiguous_eval_chunks(n_samples: int, num_replicas: int,
                           rank: int) -> List[int]:
    """Sequential eval split: rank r gets samples [r*chunk, (r+1)*chunk)
    (distributed_sampler.py:30-47); last rank absorbs the remainder."""
    chunk = int(np.ceil(n_samples / num_replicas))
    start = rank * chunk
    return list(range(start, min(start + chunk, n_samples)))
