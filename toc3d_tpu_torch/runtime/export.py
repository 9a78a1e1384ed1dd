"""Export of the streaming detector as ``torch.export`` programs, loadable
without the model code (counterpart of toc3d_tpu/runtime/export.py).

The frame's two stages, as ``make_infer_fn`` runs them (backbone + neck,
head + decode), are traced with ``torch.export.export(strict=False)`` and
saved with ``torch.export.save``; the kernels appear in the programs as the
``toc3d::`` custom ops (ops/cuda/library.py), which run the card's kernels
(and count their launches) when a loaded program runs on CUDA tensors, and
their plain versions on CPU tensors. No decomposition is run on the
programs: they call the ATen ops eager inference calls.

The weights are the programs' first input, a dict of tensors, not constants
baked into each program: the ToC3D backbone is two programs (JAX decides
first frame or steady inside one program with ``lax.cond``; the port
decides it on the host from ``prev_exists``, as runtime/graphs.CapturedInfer
does, and the loader picks the program), and the two share every weight. So
each weight is stored once, in ``weights.pt``: exactly the tensors the
programs read, which are the kernels' packs as ``make_infer_fn`` feeds them
(the bf16 packs, or the int8 packs with their static activation scales
where ``attach_act_scales`` put them) and the parameters read as they are
(neck, head, selectors, position embedding); an f32 original that a pack
replaces is not saved. Which tensors a program reads is recorded in one
eager run of it before the trace, and checked against the trace after it.

Artifact layout (one directory):
  backbone_first.pt2, backbone_steady.pt2 -- (weights, img, memory, frame)
                      -> features; the plain backbone: backbone.pt2
  head.pt2          -- (weights, memory, features, frame) -> (memory',
                       (bboxes, scores, labels, valid))
  weights.pt        -- {name: tensor}, every program's weights, each once
  memory.pt         -- the initial memory bank, {field: tensor}
  manifest.json     -- batch, views, shapes and dtypes of the frame and the
                       features, the programs and their weight names, the
                       toc3d ops they call, versions

``load_detector`` imports only the op registry (ops/cuda/library.py), the
capture machinery (runtime/capture.py) and ``torch.export.load``; nothing
under ``toc3d_tpu_torch/models``. On CUDA the loaded detector replays its
programs as captured CUDA graphs (ExportedDetector), the counterpart of
JAX's jit of its deserialized programs (toc3d_tpu/runtime/export.py:
222-223); ``ExportedDetector.eager`` runs them op by op.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.coder import DecodedBoxes
from ..core.state import DetectorState, MemoryBank, is_steady
from ..ops.cuda import PACK_CACHE
from .capture import FrameRunner

FORMAT = "toc3d_tpu_torch.export.v1"

# frame keys the programs take, in the order the loader rebuilds the dict
# (as toc3d_tpu/runtime/export.py FRAME_KEYS)
FRAME_KEYS = ("img", "intrinsics", "img2lidar", "timestamp", "ego_pose",
              "ego_pose_inv", "prev_exists")

# the model subtrees each stage reads
_BACKBONE_ROOTS = ("img_backbone", "img_neck")
_HEAD_ROOTS = ("pts_bbox_head",)


def frame_specs(cfg, batch_size: int = 1, num_views: int = 6,
                img_dtype=torch.float32) -> Dict[str, Tuple[tuple, object]]:
    """{key: (shape, dtype)} of a frame at ``cfg.pad_shape``. img_dtype
    torch.uint8: raw BGR frames, normalized inside the backbone program
    (detector.extract_img_feat)."""
    h, w = cfg.pad_shape
    b, n = batch_size, num_views
    f32 = torch.float32
    return {"img": ((b, n, h, w, 3), img_dtype),
            "intrinsics": ((b, n, 4, 4), f32),
            "img2lidar": ((b, n, 4, 4), f32),
            "timestamp": ((b,), f32), "ego_pose": ((b, 4, 4), f32),
            "ego_pose_inv": ((b, 4, 4), f32), "prev_exists": ((b,), f32)}


# ---------------------------------------------------------------------------
# the programs' weights
# ---------------------------------------------------------------------------

def _pack_leaves(value, prefix):
    """(name, tensor) of every tensor in a pack (nested tuples and
    NamedTuples), named by field."""
    if isinstance(value, torch.Tensor):
        yield prefix, value
    elif isinstance(value, tuple):
        names = getattr(value, "_fields", range(len(value)))
        for f, v in zip(names, value):
            yield from _pack_leaves(v, f"{prefix}.{f}")


def _pack_with(value, prefix, bound):
    """The pack ``value`` with each tensor named in ``bound`` replaced."""
    if isinstance(value, torch.Tensor):
        return bound.get(prefix, value)
    if isinstance(value, tuple):
        names = getattr(value, "_fields", range(len(value)))
        items = [_pack_with(v, f"{prefix}.{f}", bound)
                 for f, v in zip(names, value)]
        return type(value)(*items) if hasattr(value, "_fields") \
            else tuple(items)
    return value


def _candidates(model, roots) -> Dict[str, torch.Tensor]:
    """Every tensor a stage may read: the parameters and buffers of the
    ``roots`` subtrees (state-dict names) and every tensor of their
    modules' weight packs (``<module>:<pack>.<field>``)."""
    out = {}
    for root in roots:
        for path, mod in model.get_submodule(root).named_modules(
                prefix=root):
            for slots in (mod._parameters, mod._buffers):
                for n, t in slots.items():
                    if t is not None:
                        out[f"{path}.{n}"] = t
            for pack, (_, value) in mod.__dict__.get(PACK_CACHE, {}).items():
                out.update(_pack_leaves(value, f"{path}:{pack}"))
    return out


class _Reads(TorchDispatchMode):
    """Records which of ``tensors`` (by identity) an eager run passes to an
    op (an ATen op or a toc3d op)."""

    def __init__(self, tensors):
        super().__init__()
        self.ids = {id(t) for t in tensors}
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and id(t) in self.ids:
                self.seen.add(id(t))
        return func(*args, **kwargs)


@contextmanager
def _bound(model, weights):
    """Within: each parameter, buffer and pack tensor named in ``weights``
    reads as the given tensor (under the trace: the program's input)."""
    saved = []
    try:
        for name, t in weights.items():
            if ":" in name:
                continue
            path, _, attr = name.rpartition(".")
            mod = model.get_submodule(path)
            slots = mod._parameters if attr in mod._parameters \
                else mod._buffers
            saved.append((slots, attr, slots[attr]))
            slots[attr] = t
        packs = {n.split(":")[0] for n in weights if ":" in n}
        for path in packs:
            cache = model.get_submodule(path).__dict__[PACK_CACHE]
            for pack, (key, value) in list(cache.items()):
                saved.append((cache, pack, (key, value)))
                cache[pack] = (key, _pack_with(value, f"{path}:{pack}",
                                               weights))
        yield
    finally:
        for slots, attr, t in reversed(saved):
            slots[attr] = t


class _Program(torch.nn.Module):
    """The traced root: ``fn(*args)`` with the model's tensors bound to the
    ``weights`` input. It holds the model outside its module tree, so the
    program owns no parameter."""

    def __init__(self, model, fn):
        super().__init__()
        self.__dict__["_model"] = model
        self.__dict__["_fn"] = fn

    def forward(self, weights, *args):
        with _bound(self._model, weights):
            return self._fn(*args)


def _export(model, roots, fn, args, clones):
    """Run ``fn(*args)`` once eagerly to record which candidate tensors it
    reads, then trace it with those as the program's weights (each a copy
    of its own storage, shared through ``clones`` across programs). Returns
    (program, weight names, eager output)."""
    cands = _candidates(model, roots)
    reads = _Reads(cands.values())
    with reads:
        out = fn(*args)
    names = [n for n, t in cands.items() if id(t) in reads.seen]
    weights = {n: clones.setdefault(n, cands[n].detach().clone())
               for n in names}
    prog = torch.export.export(_Program(model, fn), (weights, *args),
                               strict=False)
    # the trace must read the model only through its weight inputs: a
    # model tensor kept as a constant would be stored in the program too
    model_storages = {t.untyped_storage().data_ptr(): n
                      for n, t in cands.items() if t.numel()}
    for c in prog.constants.values():
        read = isinstance(c, torch.Tensor) and c.numel() and \
            model_storages.get(c.untyped_storage().data_ptr())
        if read:
            raise RuntimeError(f"the trace read {read} outside the "
                               "program's weight inputs")
    inputs = [s.arg.name for s in prog.graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    users = {n.name: len(n.users) for n in prog.graph.nodes
             if n.op == "placeholder"}
    unused = [w for w, p in zip(names, inputs) if not users[p]]
    if unused:
        raise RuntimeError(f"weights recorded but not read by the trace: "
                           f"{unused[:5]}")
    return prog, names, out


def _toc3d_ops(prog):
    return {n.target.name() for n in prog.graph.nodes
            if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "toc3d"}


def _example_frame(specs, device, prev_exists: float):
    f = {}
    for k, (shape, dtype) in specs.items():
        f[k] = torch.zeros(shape, dtype=dtype, device=device)
        if shape[-2:] == (4, 4):
            f[k] += torch.eye(4, device=device)
    f["prev_exists"].fill_(prev_exists)
    return f


def export_detector(model, out_dir: str, batch_size: int = 1,
                    num_views: int = 6, img_dtype=torch.float32) -> dict:
    """Export the streaming detector ``model`` (a models.detector
    ToC3DDetector, on the device the artifact will run on) to ``out_dir``;
    returns the manifest. Casts or quantizes the weights first as
    ``make_infer_fn`` does (precast_backbone_); to export static int8,
    attach calibrated scales before (ops/int8_calib.attach_act_scales).
    img_dtype torch.uint8: the programs take raw uint8 frames, normalized on
    the device. eval_mask 'gumbel' draws noise every frame and has no
    fixed-signature program: it raises ValueError; a VoVNet backbone
    raises NotImplementedError."""
    from ..models.detector import (extract_img_feat, head_step, init_state,
                                   precast_backbone_, require_vit)
    cfg = model.cfg
    require_vit(cfg, "export")
    if getattr(cfg.backbone, "eval_mask", "softmax") == "gumbel":
        raise ValueError("eval_mask='gumbel' (stochastic eval) is not "
                         "exportable; use the deterministic default")
    precast_backbone_(model)
    dev = next(model.parameters()).device
    specs = frame_specs(cfg, batch_size, num_views, img_dtype)
    memory = tuple(init_state(batch_size, cfg, device=dev).memory)
    variants = ((("backbone_first", False), ("backbone_steady", True))
                if cfg.is_toc3d else (("backbone", None),))
    clones: Dict[str, torch.Tensor] = {}
    programs, manifest_programs, ops = {}, {}, set()
    with torch.no_grad():
        for name, steady in variants:
            frame = _example_frame(specs, dev, 1.0 if steady else 0.0)

            def backbone(img, mem, frame, steady=steady):
                return extract_img_feat(model, img, MemoryBank(*mem), frame,
                                        steady=steady)
            programs[name], names, feats = _export(
                model, _BACKBONE_ROOTS, backbone,
                (frame["img"], memory, frame), clones)
            manifest_programs[name] = {"file": f"{name}.pt2",
                                       "weights": names}

        def head(mem, feats, frame):
            state, det = head_step(model, DetectorState(MemoryBank(*mem)),
                                   feats, frame)
            return tuple(state.memory), tuple(det)
        programs["head"], names, _ = _export(
            model, _HEAD_ROOTS, head, (memory, feats, frame), clones)
        manifest_programs["head"] = {"file": "head.pt2", "weights": names}

    os.makedirs(out_dir, exist_ok=True)
    for name, prog in programs.items():
        # a program keeps its example inputs, the weights among them, and
        # would save them beside its graph
        prog.example_inputs = None
        torch.export.save(prog, os.path.join(out_dir, f"{name}.pt2"))
        ops |= _toc3d_ops(prog)
    torch.save(clones, os.path.join(out_dir, "weights.pt"))
    torch.save(dict(zip(MemoryBank._fields, memory)),
               os.path.join(out_dir, "memory.pt"))
    manifest = {
        "format": FORMAT,
        "batch_size": batch_size,
        "num_views": num_views,
        "pad_shape": list(cfg.pad_shape),
        "compute_dtype": cfg.compute_dtype,
        "quant": {"backbone": cfg.backbone.quant,
                  "head": cfg.head.decoder.quant},
        "frame_keys": list(FRAME_KEYS),
        "frame_specs": {k: {"shape": list(s), "dtype": str(d)[6:]}
                        for k, (s, d) in specs.items()},
        "feats": {"shape": list(feats.shape), "dtype": str(feats.dtype)[6:]},
        "device": dev.type,
        "backbone_choice": ("the host picks backbone_steady when every "
                            "prev_exists > 0, else backbone_first"
                            if cfg.is_toc3d else "one backbone program"),
        "programs": manifest_programs,
        "weights": {"file": "weights.pt", "count": len(clones),
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in clones.values())},
        "memory": "memory.pt",
        "ops": sorted(ops),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# load / serve
# ---------------------------------------------------------------------------

class ExportedDetector:
    """A served detector: ``make_infer_fn``'s results, rebuilt from the
    artifact with no model code.

        det = ExportedDetector(path)
        state = det.init_state()
        state, boxes = det(state, frame)   # frame: dict of numpy / tensors

    On CUDA a call replays captured CUDA graphs through the runner
    make_infer_fn's runtime/graphs.CapturedInfer uses
    (runtime/capture.FrameRunner): one graph per backbone program (the
    host picks it from ``prev_exists``) and one for the head. Each call
    checks the frame against the manifest's shapes and dtypes on the host
    (a replay runs no Python, so the loaded programs' own input checks no
    longer run) before the runner copies it into static buffers; the
    weights are the loaded tensors, at fixed addresses for the detector's
    life. A capture or replay that fails raises. ``eager(state, frame)``
    runs the loaded programs op by op (each op and kernel launched from the
    host), as ``infer_step`` runs the model; on the CPU a call is that
    eager run.
    """

    def __init__(self, path: str, device="cuda"):
        from ..ops.cuda import library  # noqa: F401  (registers toc3d ops)
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        m = self.manifest
        if m.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} artifact")
        self.device = torch.device(device)
        if self.device.type != m["device"]:
            raise ValueError(f"{path} was exported for {m['device']}, not "
                             f"{self.device.type}")
        weights = torch.load(os.path.join(path, m["weights"]["file"]),
                             map_location=self.device, weights_only=True)
        self._programs = {
            name: (torch.export.load(os.path.join(path, p["file"])).module(),
                   {n: weights[n] for n in p["weights"]})
            for name, p in m["programs"].items()}
        mem = torch.load(os.path.join(path, m["memory"]),
                         map_location=self.device, weights_only=True)
        self._mem0 = MemoryBank(**mem)
        self._specs = {k: (tuple(s["shape"]), getattr(torch, s["dtype"]))
                       for k, s in m["frame_specs"].items()}
        self.runner = FrameRunner(self.device)

    def init_state(self) -> DetectorState:
        return DetectorState(MemoryBank(*(t.clone() for t in self._mem0)))

    def _frame(self, frame):
        """The frame's tensors where they lie, each checked against the
        manifest's shape and dtype (ValueError)."""
        out = {}
        for k in FRAME_KEYS:
            v = frame[k]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            shape, dtype = self._specs[k]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"frame[{k!r}]: {tuple(t.shape)} "
                                 f"{t.dtype} for a program exported with "
                                 f"{shape} {dtype}")
            out[k] = t
        return out

    def _backbone_name(self, frame) -> str:
        """The host reads ``prev_exists`` where it lies (no device read for
        a numpy array or a host tensor) to pick the backbone program."""
        if "backbone" in self._programs:
            return "backbone"
        return "backbone_steady" if is_steady(frame) else "backbone_first"

    @torch.no_grad()
    def eager(self, state: DetectorState, frame) -> Tuple[DetectorState,
                                                          DecodedBoxes]:
        """One frame through the loaded programs, op by op."""
        name = self._backbone_name(frame)
        frame = {k: t.to(self.device, non_blocking=True)
                 for k, t in self._frame(frame).items()}
        mem = tuple(state.memory)
        bb, w = self._programs[name]
        feats = bb(w, frame["img"], mem, frame)
        hd, w = self._programs["head"]
        mem, det = hd(w, mem, feats, frame)
        return DetectorState(MemoryBank(*mem)), DecodedBoxes(*det)

    def _backbone(self, name):
        bb, w = self._programs[name]
        return lambda frame, bank: bb(w, frame["img"], tuple(bank), frame)

    def _head(self, bank, feats, frame):
        hd, w = self._programs["head"]
        return hd(w, tuple(bank), feats, frame)

    @torch.no_grad()
    def __call__(self, state: DetectorState, frame) -> Tuple[DetectorState,
                                                             DecodedBoxes]:
        """One frame: replayed graphs on CUDA, the eager run on the
        CPU."""
        if self.device.type != "cuda":
            return self.eager(state, frame)
        return self._replay(state, frame)

    def _replay(self, state, frame):
        name = self._backbone_name(frame)
        return self.runner(self._frame(frame), state.memory, name,
                           self._backbone(name), self._head)


def load_detector(path: str, device="cuda") -> ExportedDetector:
    return ExportedDetector(path, device)
