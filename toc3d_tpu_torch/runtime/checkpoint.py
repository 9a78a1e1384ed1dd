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

``load_backbone_pretrained`` merges a public backbone checkpoint (EVA-02,
SAM, MAE or ViTDet naming) into a fresh detector, the warm start the paper
trains from (toc3d_tpu/runtime/checkpoint.py:311-365).
"""
from __future__ import annotations

import os

import numpy as np
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


# ---------------------------------------------------------------------------
# public pretrained backbone warm start (EVA-02 / SAM / MAE / ViTDet)
# ---------------------------------------------------------------------------

# prefix rewrites of the reference's warm-start shims (tools/train.py:
# 260-340): SAM image_encoder, ViTDet backbone.net, bare MAE keys; applied
# to each key in this order, each at most once
PRETRAINED_PREFIX_REWRITES = (
    ("image_encoder.", "img_backbone."),
    ("backbone.net.", "img_backbone."),
    ("module.", ""),
)

# the keys of a block that JAX's convert_eva_block always reads: a block
# loads only when all are present
_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.q_proj.weight",
               "attn.q_bias", "attn.k_proj.weight", "attn.v_proj.weight",
               "attn.v_bias", "attn.proj.weight", "norm2.weight",
               "norm2.bias", "mlp.w1.weight", "mlp.w2.weight",
               "mlp.w3.weight", "mlp.ffn_ln.weight", "mlp.ffn_ln.bias")
# the linears' biases, read where present: JAX's linear without one adds
# none, a zero bias here
_BLOCK_BIASES = ("attn.proj.bias", "mlp.w1.bias", "mlp.w2.bias",
                 "mlp.w3.bias")


def _f32(v) -> torch.Tensor:
    """A checkpoint value (tensor or array) as an f32 tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32))


def _merge(module, sd, prefix, required, optional=()) -> bool:
    """Copy ``sd[prefix + name]`` into each parameter ``name`` of
    ``module`` when every ``required`` name is present (an ``optional`` one
    that is absent is zeroed); False, and nothing written, otherwise."""
    if not all(prefix + k in sd for k in required):
        return False
    for k in required + optional:
        p = module.get_parameter(k)
        if prefix + k in sd:
            p.copy_(_f32(sd[prefix + k]))
        else:
            p.zero_()
    return True


@torch.no_grad()
def load_backbone_pretrained(model, state_dict) -> dict:
    """Merge a public backbone checkpoint (EVA-02 / SAM / MAE / ViTDet
    naming; tensors or numpy arrays) into ``model``, a detector, in place
    and non-strict: what converts is taken, the rest (selectors, neck,
    head, absent blocks) keeps its init. Returns {"loaded": [...],
    "missing": [...]}, JAX's report (checkpoint.py:322-365): ``pos_embed``
    is loaded when present and never missing; ``patch_embed`` and each of
    the model's blocks are loaded or missing, a block whole or not at all.
    A ``pos_embed`` of another grid replaces the parameter at its own shape
    (the forward resamples it, ops/resize.resize_abs_pos). The copies
    change the model's weight key (ops.cuda.param_key), so the weight
    packs are rebuilt and the captured frame captured again."""
    sd = {}
    for k, v in state_dict.items():
        for old, new in PRETRAINED_PREFIX_REWRITES:
            if k.startswith(old):
                k = new + k[len(old):]
        if not k.startswith("img_backbone."):
            k = "img_backbone." + k     # MAE checkpoints use bare keys
        sd[k] = v
    bb = model.img_backbone
    loaded, missing = [], []
    if "img_backbone.pos_embed" in sd:
        dev = bb.patch_embed.proj.weight.device
        bb.pos_embed = torch.nn.Parameter(_f32(
            sd["img_backbone.pos_embed"]).to(dev, copy=True))
        loaded.append("pos_embed")
    (loaded if _merge(bb.patch_embed.proj, sd,
                      "img_backbone.patch_embed.proj.", ("weight",),
                      ("bias",)) else missing).append("patch_embed")
    for i, blk in enumerate(bb.blocks):
        (loaded if _merge(blk, sd, f"img_backbone.blocks.{i}.", _BLOCK_KEYS,
                          _BLOCK_BIASES) else missing).append(f"blocks.{i}")
    return {"loaded": loaded, "missing": missing}
