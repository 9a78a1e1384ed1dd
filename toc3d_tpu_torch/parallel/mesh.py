"""Process groups and the collectives of data-parallel training
(counterpart of toc3d_tpu/parallel/mesh.py).

The reference distributes training by DDP over NCCL, one process per GPU
(SURVEY.md §2d; dist_train.sh's env:// rendezvous). JAX puts the batch on a
'data' mesh axis and lets XLA insert the gradient pmean. Here each process
owns one device and holds its lanes of the global batch; the train step
all-reduces the gradients explicitly (``GradReducer``), between the
backward and the optimizer, which is what DDP's reducer does, without its
overlap with the backward.

The backend follows the device: NCCL for a CUDA device, gloo only when the
caller asks for the CPU. Nothing switches from one to the other, and a
failed collective raises.

``make_mesh``'s ('dcn', 'data') hierarchy has no counterpart: NCCL builds
its own rings and trees within and across hosts, so the data-parallel
group is the flat world. XLA's sharding specs (``dp_spec``,
``batch_sharding``, ``replicate``) have none either: a process's tensors
are its own, so "replicated" means every rank holds the same values
(``broadcast_tensors`` from rank 0) and "batch-sharded" means each rank
holds its lanes (``local_lanes``, ``shard_batch``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# The gradient buckets' size: DDP's default bucket_cap_mb.
BUCKET_BYTES = 25 << 20


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments the rendezvous is torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT); with them it is
    ``tcp://coordinator`` (host:port), or ``coordinator`` itself when it
    names a scheme (``file:///path`` rendezvouses through a shared file).
    ``device`` 'cuda' joins over NCCL on ``cuda:LOCAL_RANK`` (LOCAL_RANK
    from the environment, else the process id modulo the visible cards)
    and raises without a card; 'cpu' joins over gloo. Any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: distributed training on the "
                               "card uses NCCL (pass --device cpu for gloo)")
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device {device!r}")
    if coordinator is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no rendezvous: run under torchrun (RANK, "
                               "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or "
                               "give a coordinator")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        rank, world = int(process_id), int(num_processes)
        init_method = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
    dev = torch.device("cpu")
    kwargs = {}
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None \
            else rank % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return dev


def world_size(group=None) -> int:
    """The group's size; 1 without a process group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in the group; 0 without a process group."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def src_rank(group=None) -> int:
    """The global rank of the group's rank 0 (the source of broadcasts)."""
    if group is None or group is dist.group.WORLD:
        return 0
    return dist.get_global_rank(group, 0)


def local_lanes(n: int, group=None) -> slice:
    """This rank's lanes of a global batch of n lanes: the r-th of world
    equal, contiguous blocks (the counterpart of shard_batch's split of the
    leading axis over 'data')."""
    w, r = world_size(group), rank(group)
    if n % w:
        raise ValueError(f"a batch of {n} lanes does not split over {w} "
                         "ranks")
    per = n // w
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's lanes of every array of a global batch (leading axis)."""
    n = len(next(iter(batch.values())))
    lanes = local_lanes(n, group)
    return {k: v[lanes] for k, v in batch.items()}


def reduce_mean(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``tensor`` over the ranks, as a new tensor (the
    reference's mmdet reduce_mean: divide by the world size, then sum); the
    tensor itself without a process group."""
    if not dist.is_initialized():
        return tensor
    tensor = tensor.clone()
    dist.all_reduce(tensor.div_(dist.get_world_size(group)),
                    op=dist.ReduceOp.SUM, group=group)
    return tensor


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite each tensor, in place, with the group's rank 0's."""
    src = src_rank(group)
    for t in tensors:
        dist.broadcast(t, src, group=group)


def broadcast_train_state(model, opt_state: dict, group=None) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank (the
    start of a data-parallel run: every rank then applies the same averaged
    gradients, so they stay equal)."""
    broadcast_tensors(list(model.state_dict().values())
                      + [opt_state["count"], opt_state["notfinite"]]
                      + list(opt_state["mu"]) + list(opt_state["nu"]),
                      group)


def gather_lanes(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' lanes of a batch-leading tensor, joined in rank order."""
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class GradReducer:
    """The data-parallel gradient average: the gradients are copied into
    flat buckets of about ``BUCKET_BYTES`` (consecutive parameters of one
    dtype), each bucket is summed over the group in place and divided by
    the group's size. ``reduce`` returns the averaged gradients as views
    of the buckets, one per parameter, in the parameters' order; a
    parameter without a gradient takes zeros, as jax.grad gives it, so
    every rank sends the same buckets. The buckets are allocated once and
    reused every step."""

    def __init__(self, params: Sequence[torch.Tensor], group=None):
        self.group = group
        self.world = world_size(group)
        runs: List[List[int]] = []
        size = 0
        for i, p in enumerate(params):
            nbytes = p.numel() * p.element_size()
            if (not runs or p.dtype != params[runs[-1][0]].dtype
                    or size + nbytes > BUCKET_BYTES):
                runs.append([])
                size = 0
            runs[-1].append(i)
            size += nbytes
        self.views: List[Optional[torch.Tensor]] = [None] * len(params)
        self.buckets = []
        for idx in runs:
            flat = torch.empty(sum(params[i].numel() for i in idx),
                               dtype=params[idx[0]].dtype,
                               device=params[idx[0]].device)
            off = 0
            for i in idx:
                n = params[i].numel()
                self.views[i] = flat[off:off + n].view(params[i].shape)
                off += n
            self.buckets.append((flat, idx))

    @torch.no_grad()
    def reduce(self, grads: Sequence[Optional[torch.Tensor]]):
        for flat, idx in self.buckets:
            have = [i for i in idx if grads[i] is not None]
            if have:
                torch._foreach_copy_([self.views[i] for i in have],
                                     [grads[i] for i in have])
            for i in idx:
                if grads[i] is None:
                    self.views[i].zero_()
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.div_(self.world)
        return list(self.views)
