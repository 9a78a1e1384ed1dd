"""Device-side linear assignment: Bertsekas' auction (counterpart of
toc3d_tpu/core/auction.py :: _auction_phase :23, auction_assign :72,
hungarian_match_auction :103).

Persons are the GT slots (few), objects the queries (many). One cold phase
at eps = spread / eps_div: in each round every unassigned valid person
bids at once (Jacobi) on its best object, at price + (best - second-best
value) + eps; each object goes to its highest bidder, the lowest person id
among equal bids; ownership is the one record, and a person's assignment
is derived from it. The rounds stop once every valid person owns an
object, or after max_iters. At eps_div 20000 the result is within
P * spread / 20000 of the optimum, and in JAX's measurements equal to the
exact LAP at Q 900, G <= 96 (tests/test_auction_scale.py).

``auction_plain`` is the rounds as torch ops, JAX's round arithmetic step
by step in the same float32 order (``values = benefit - price``, then
``bid = (price[best] + (best - second)) + eps``; the first index on ties,
as jnp.argmax). It is the path for CPU tensors and the oracle of the CUDA
kernel; ``ops/cuda/auction.auction_match``, JAX's
``hungarian_match_auction``, takes one or the other by the tensor's device
(the kernel, csrc/auction.cu, runs the whole loop of a problem in one CTA
and equals the plain rounds exactly).
"""
from __future__ import annotations

import torch

NEG = -1e9
MAX_ITERS = 16384
EPS_DIV = 20000.0


def auction_plain(cost, n_valid, max_iters: int = MAX_ITERS,
                  eps_div: float = EPS_DIV, stats=None):
    """cost: (B, Q, G) f32, n_valid: (B,) int -> (B, G) int32, the query
    matched to each of the first n_valid GT slots (-1 past n_valid, or for
    a person still unassigned after max_iters rounds). Minimizes the total
    cost of each problem. JAX's vmap of auction_assign: each problem runs
    its own rounds and stops on its own. stats: a dict that receives
    'rounds' (the most rounds a problem ran) and 'bids' (the bids made, each
    the scan of one row of Q values), the work these inputs need."""
    cost = cost.detach().float()
    b, o, p = cost.shape
    dev = cost.device
    benefit = -cost.transpose(1, 2)                         # (B, P, O)
    pid = torch.arange(p, device=dev)
    valid = pid[None, :] < n_valid.to(dev).long()[:, None]  # (B, P)
    benefit = torch.where(valid[..., None], benefit,
                          torch.full_like(benefit, NEG))
    spread = torch.where(valid[..., None], benefit.abs(),
                         torch.zeros_like(benefit)).amax(dim=(1, 2))
    spread = torch.maximum(spread, torch.ones_like(spread))
    # a tensor divisor: an IEEE division on both devices (a Python scalar
    # divisor becomes a multiply by its reciprocal on CUDA)
    eps = spread / torch.full_like(spread, eps_div)         # (B,)

    price = torch.zeros(b, o, dtype=torch.float32, device=dev)
    owner = torch.full((b, o), -1, dtype=torch.int64, device=dev)
    neg = torch.full((b, o), NEG, dtype=torch.float32, device=dev)
    nobody = torch.full((b, o), p, dtype=torch.int64, device=dev)

    def assigned_mask(owner):
        return (owner[:, None, :] == pid[None, :, None]).any(dim=2)

    rounds, bids = 0, 0
    for _ in range(max_iters):
        assigned = assigned_mask(owner)
        active = ~(assigned | ~valid).all(dim=1)            # (B,)
        if not bool(active.any()):
            break
        bidding = valid & ~assigned                         # (B, P)
        if stats is not None:
            rounds += 1
            bids += int(bidding.sum())
        values = benefit - price[:, None, :]                # (B, P, O)
        best_o = values.argmax(dim=2)                       # (B, P)
        best_v = values.gather(2, best_o[..., None])[..., 0]
        v2 = values.scatter(2, best_o[..., None], NEG)
        second_v = v2.amax(dim=2)
        bid = price.gather(1, best_o) + (best_v - second_v) + eps[:, None]
        bid = torch.where(bidding, bid, torch.full_like(bid, NEG))
        obj_bid = neg.scatter_reduce(1, best_o, bid, "amax")
        is_top = bidding & (bid >= obj_bid.gather(1, best_o))
        cand = torch.where(is_top, pid[None, :].expand(b, p),
                           torch.full_like(best_o, p))
        winner = nobody.scatter_reduce(1, best_o, cand, "amin")
        got = (winner < p) & active[:, None]
        price = torch.where(got, obj_bid, price)
        owner = torch.where(got, winner, owner)

    if stats is not None:
        stats.update(rounds=rounds, bids=bids)
    onehot = owner[:, None, :] == pid[None, :, None]        # (B, P, O)
    obj_idx = onehot.int().argmax(dim=2)
    has = onehot.any(dim=2)
    return torch.where(valid & has, obj_idx,
                       torch.full_like(obj_idx, -1)).to(torch.int32)
