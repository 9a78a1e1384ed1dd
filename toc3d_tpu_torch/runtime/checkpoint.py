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
"""
from __future__ import annotations

import os

import torch

from ..models.streampetr_head import MemoryBank


def _cpu(t):
    return t.detach().to("cpu", copy=True)


def save_params(model, path: str) -> str:
    """The model's weights as {'state_dict': ...} at ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": {k: _cpu(v)
                               for k, v in model.state_dict().items()}},
               path)
    return path


def save_train_state(state, tx, path: str) -> str:
    """TrainState (model, optimizer state, bank, step) at ``path``; tx: the
    optimizer (runtime/train.AdamW) whose parameter order the moments
    follow."""
    opt = state.opt_state
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "state_dict": {k: _cpu(v)
                       for k, v in state.model.state_dict().items()},
        "opt_names": list(tx.names),
        "opt": {"count": _cpu(opt["count"]),
                "notfinite": _cpu(opt["notfinite"]),
                "mu": [_cpu(t) for t in opt["mu"]],
                "nu": [_cpu(t) for t in opt["nu"]]},
        "memory": [_cpu(t) for t in state.memory],
        "step": int(state.step),
    }, path)
    return path


@torch.no_grad()
def load_train_state(path: str, state, tx):
    """The TrainState saved at ``path``, restored into ``state`` (its model
    and optimizer state are written in place); raises when the saved
    optimizer's parameters are not tx's."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if ck["opt_names"] != list(tx.names):
        raise ValueError(f"{path}: the optimizer state was saved for other "
                         "parameters")
    state.model.load_state_dict(ck["state_dict"], strict=True)
    opt = state.opt_state
    for k in ("count", "notfinite"):
        opt[k] = ck["opt"][k].to(opt[k].device)
    for k in ("mu", "nu"):
        for dst, src in zip(opt[k], ck["opt"][k]):
            dst.copy_(src)
    dev = state.memory.embedding.device
    memory = MemoryBank(*(t.to(dev) for t in ck["memory"]))
    return type(state)(state.model, opt, memory, ck["step"])
