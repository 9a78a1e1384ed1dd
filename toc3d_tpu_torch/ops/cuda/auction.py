"""The auction matcher's kernel (source csrc/auction.cu).

Replaces toc3d_tpu/core/auction.py :: hungarian_match_auction (:103), the
JAX package's device matcher (plain jnp under vmap, not a pallas_call):
Bertsekas' auction over each problem of a (B, Q, G) cost tensor, one CTA a
problem with all its rounds inside, so a cost tensor is one launch and the
host reads nothing until the answer. Its plain version is
core/auction.auction_plain, which it equals exactly (``torch.equal``).
"""
from __future__ import annotations

import torch

from ...core.auction import EPS_DIV, MAX_ITERS, auction_plain
from . import check_cuda
from .build import call, stream_of

# the dynamic shared memory a CTA may take on an H100 (227 KB)
MAX_SMEM = 227 * 1024


def auction_smem(q: int, g: int) -> int:
    """Bytes of shared memory a problem of q queries and g GT slots takes
    (csrc/auction.cu auction_smem: 16 a query, 12 a slot)."""
    return 4 * (4 * q + 3 * g)


def auction_match(cost, n_valid, max_iters: int = MAX_ITERS,
                  eps_div: float = EPS_DIV):
    """cost: (B, Q, G) f32, n_valid: (B,) int, the valid GT slots of each
    problem (its first n_valid; G may exceed Q, n_valid may not, or the
    rounds run to max_iters as JAX's do). Returns (B, G) int32, the query matched to
    each slot, -1 past n_valid. A CPU tensor takes the plain rounds
    (core/auction.auction_plain); a CUDA one launches the kernel once,
    counted in ``launches``, or raises."""
    if cost.device.type == "cpu":
        return auction_plain(cost, n_valid, max_iters, eps_div)
    if cost.dim() != 3:
        raise ValueError(f"auction_match: cost {tuple(cost.shape)} must be "
                         "(B, Q, G)")
    cost = cost.detach().float().contiguous()
    nv = n_valid.detach().to(device=cost.device, dtype=torch.int32) \
        .contiguous()
    check_cuda("auction_match", cost, dtype=torch.float32, aligned=False)
    b, q, g = cost.shape
    if nv.shape != (b,):
        raise ValueError(f"auction_match: n_valid {tuple(nv.shape)} for "
                         f"{b} problems")
    if auction_smem(q, g) > MAX_SMEM:
        raise ValueError(f"auction_match: ({q}, {g}) needs "
                         f"{auction_smem(q, g)} bytes of shared memory")
    out = torch.empty(b, g, dtype=torch.int32, device=cost.device)
    if b == 0 or g == 0:
        return out
    scratch = torch.empty(b, g, q, dtype=torch.float32, device=cost.device)
    call("auction", "toc3d_auction", cost.data_ptr(), nv.data_ptr(),
         scratch.data_ptr(), out.data_ptr(), b, q, g, max_iters,
         float(eps_div), stream_of(cost))
    auction_match.launches += 1
    return out


auction_match.launches = 0
