"""Save and resume of training (counterpart of
toc3d_tpu/runtime/checkpoint.py :: save_params / save_train_state /
load_train_state, :368-404; the reference's mmcv CheckpointHook and
runner.resume, mmdet_train.py:200-206), with torch.save.

``save_train_state`` writes the whole TrainState: the model's
reference-named state dict, the optimizer's moments (in the optimizer's
parameter order, with the names to check it), its counters, the memory
bank and the step. ``load_train_state`` restores one into an existing
state of the same configuration, so two steps, a save, a load and a step
give exactly what three uninterrupted steps give. ``save_params`` writes
the weights alone as {'state_dict': ...}, the layout
convert.load_reference_checkpoint (and so the eval CLI's --checkpoint)
reads.

Data parallel (``group``, parallel/mesh.py): every rank holds the same
parameters and optimizer state, and its own lanes of the memory bank. A
save gathers the lanes to every rank in rank order and only the group's
rank 0 writes, so the file is the one a single process at the global batch
would write; a load reads it on rank 0, broadcasts the parameters, the
optimizer state and the bank, and each rank keeps its own lanes.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..models.streampetr_head import MemoryBank
from ..parallel import mesh


def _cpu(t):
    return t.detach().to("cpu", copy=True)


def save_params(model, path: str) -> str:
    """The model's weights as {'state_dict': ...} at ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": {k: _cpu(v)
                               for k, v in model.state_dict().items()}},
               path)
    return path


def save_train_state(state, tx, path: str, group=None) -> str:
    """TrainState (model, optimizer state, bank, step) at ``path``; tx: the
    optimizer (runtime/train.AdamW) whose parameter order the moments
    follow. group: a data-parallel process group; every rank of it calls
    this, the bank's lanes are joined in rank order and rank 0 writes."""
    opt = state.opt_state
    memory = state.memory
    if group is not None:
        memory = [mesh.gather_lanes(t, group) for t in memory]
        if mesh.rank(group) != 0:
            return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "state_dict": {k: _cpu(v)
                       for k, v in state.model.state_dict().items()},
        "opt_names": list(tx.names),
        "opt": {"count": _cpu(opt["count"]),
                "notfinite": _cpu(opt["notfinite"]),
                "mu": [_cpu(t) for t in opt["mu"]],
                "nu": [_cpu(t) for t in opt["nu"]]},
        "memory": [_cpu(t) for t in memory],
        "step": int(state.step),
    }, path)
    return path


@torch.no_grad()
def load_train_state(path: str, state, tx, group=None):
    """The TrainState saved at ``path``, restored into ``state`` (its model
    and optimizer state are written in place); raises when the saved
    optimizer's parameters are not tx's. group: a data-parallel process
    group; every rank of it calls this, rank 0 reads the file, the rest is
    broadcast and each rank keeps its lanes of the bank."""
    lead = group is None or mesh.rank(group) == 0
    ck = torch.load(path, map_location="cpu", weights_only=True) \
        if lead else None
    if group is not None:
        head = [None if ck is None else
                (ck["opt_names"], ck["step"],
                 [tuple(t.shape) for t in ck["memory"]])]
        dist.broadcast_object_list(head, mesh.src_rank(group), group=group)
        names, step, shapes = head[0]
    else:
        names, step = ck["opt_names"], ck["step"]
    if names != list(tx.names):
        raise ValueError(f"{path}: the optimizer state was saved for other "
                         "parameters")
    opt = state.opt_state
    dev = state.memory.embedding.device
    if lead:
        state.model.load_state_dict(ck["state_dict"], strict=True)
        for k in ("count", "notfinite"):
            opt[k] = ck["opt"][k].to(opt[k].device)
        for k in ("mu", "nu"):
            for dst, src in zip(opt[k], ck["opt"][k]):
                dst.copy_(src)
        memory = [t.to(dev) for t in ck["memory"]]
    else:
        memory = [torch.empty(s, dtype=t.dtype, device=dev)
                  for s, t in zip(shapes, state.memory)]
    if group is not None:
        mesh.broadcast_train_state(state.model, opt, group)
        mesh.broadcast_tensors(memory, group)
        lanes = mesh.local_lanes(len(memory[0]), group)
        memory = [t[lanes].contiguous() for t in memory]
    return type(state)(state.model, opt, MemoryBank(*memory), step)
