"""Streaming ToC3D detector, inference (counterpart of
toc3d_tpu/models/detector.py; reference petr3d.py:543-594).

The whole inter-frame state is a DetectorState (the head's memory bank)
threaded through ``infer_step``:

    state, boxes = infer_step(model, state, frame)

frame keys as in the JAX package (detector.py:247-251), B-leading tensors:
img (B, N, H, W, 3) float (normalized) or uint8 (BGR, normalized here on the
device); intrinsics (B, N, 4, 4); img2lidar (B, N, 4, 4); timestamp (B,)
relative seconds; ego_pose / ego_pose_inv (B, 4, 4); prev_exists (B,) in
{0, 1}.

Entry points build models and state on ``cuda`` unless the caller passes
``device="cpu"``; on the card the backbone and decoder run the port's
Hopper kernels (ops/cuda).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..core.coder import DecodedBoxes, nms_free_decode, to_bottom_center
from ..core.state import DetectorState, is_steady
from ..ops.consts import const_vector
from ..runtime.timer import span, stage
from .neck import CPFPN, CPFPNConfig, cpfpn_forward, pack_cpfpn
from .streampetr_head import (MemoryBank, StreamPETRHead,
                              StreamPETRHeadConfig, head_forward, init_memory)
from .eva_vit import EVAViT, EVAViTConfig, eva_vit_forward
from .toc3d_vit import ToC3DViT, ToC3DViTConfig, toc3d_vit_forward
from .vovnet import VoVNet, VoVNetConfig, pack_vovnet, vovnet_forward
from .focal_head import FocalHeadConfig, FocalHeadParams
from .token_select import gumbel_


@dataclass(frozen=True)
class DetectorConfig:
    """Field names of detector.py:35-55. backbone: an EVAViTConfig (the
    plain EVA-02 of the StreamPETR presets), a ToC3DViTConfig, or a
    VoVNetConfig (StreamPETR's V2-99; inference only), its neck's
    in_channels then one a VoVNet output level. The grid mask, the 2D head
    and the frame-gradient counts are read by training only
    (runtime/train.py)."""
    backbone: Union[EVAViTConfig, VoVNetConfig] = field(
        default_factory=ToC3DViTConfig)
    neck: CPFPNConfig = field(default_factory=CPFPNConfig)
    head: StreamPETRHeadConfig = field(default_factory=StreamPETRHeadConfig)
    focal: FocalHeadConfig = field(default_factory=FocalHeadConfig)
    use_grid_mask: bool = True
    aux_2d_only: bool = True
    stride: int = 16
    position_level: int = 0
    num_frame_backbone_grads: int = 1
    num_frame_head_grads: int = 1
    num_frame_losses: int = 1
    pad_shape: Tuple[int, int] = (320, 800)
    compute_dtype: str = "float32"   # backbone dtype: 'float32' | 'bfloat16'

    @property
    def is_vit(self) -> bool:
        """An EVA-02 ViT backbone (EVAViTConfig or ToC3DViTConfig); else
        the VoVNet CNN. Every model function that depends on the backbone
        dispatches on this."""
        return isinstance(self.backbone, EVAViTConfig)

    @property
    def is_toc3d(self) -> bool:
        """Token compression runs: a ToC3DViTConfig with a pruning location
        (detector.py:53-55); otherwise the plain backbone's forward."""
        return isinstance(self.backbone, ToC3DViTConfig) and bool(
            self.backbone.pruning_loc)


# keys of a reference checkpoint that are buffers the port recomputes, or
# aliases of the shared branches (runtime/checkpoint.py _BUFFER_PAT)
_BUFFER_PAT = re.compile(
    r"(rope_|freqs_|code_weights|match_costs|pc_range|position_range|"
    r"coords_d|cls_branches\.[1-9]|reg_branches\.[1-9])")


def require_vit(cfg: DetectorConfig, what: str) -> None:
    """Raise unless the backbone is an EVA-02 ViT: ``what`` (training,
    export, the collected forward) is written for the ViT backbones
    only."""
    if not cfg.is_vit:
        raise NotImplementedError(
            f"{what} runs the EVA-02 ViT backbones only, not a "
            f"{type(cfg.backbone).__name__} "
            f"({getattr(cfg.backbone, 'spec_name', '')}) backbone")


def build_backbone(cfg: DetectorConfig) -> nn.Module:
    """ToC3DViT for a ToC3DViTConfig, the plain EVAViT for an EVAViTConfig
    (detector.py:63-68; no score_predictor), VoVNet for a VoVNetConfig."""
    if not cfg.is_vit:
        return VoVNet(cfg.backbone)
    return (ToC3DViT if isinstance(cfg.backbone, ToC3DViTConfig)
            else EVAViT)(cfg.backbone)


class ToC3DDetector(nn.Module):
    """Petr3D module tree with the reference (mmdet3d) parameter names; the
    backbone as ``build_backbone`` makes it."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        self.img_backbone = build_backbone(cfg)
        self.img_neck = CPFPN(cfg.neck)
        self.pts_bbox_head = StreamPETRHead(cfg.head)
        self.img_roi_head = FocalHeadParams(cfg.focal)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Load a reference-named state dict (numpy arrays or tensors).
        Buffer keys (RoPE tables, code weights, ranges) and the aliased
        cls/reg branch copies 1..L-1 are dropped first, as the JAX
        converter skips them; everything else must match exactly. A ViT
        block's calibrated int8 activation scales (``img_backbone.blocks.
        {i}.act_scales``, see convert.params_from_jax) are attached to that
        block; a block without them in the dict loses any it had."""
        from .eva_vit import set_act_scales
        sd = {}
        for k, v in state_dict.items():
            if _BUFFER_PAT.search(k):
                continue
            sd[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
        if self.cfg.is_vit:
            for i, blk in enumerate(self.img_backbone.blocks):
                set_act_scales(blk,
                               sd.get(f"img_backbone.blocks.{i}.act_scales"))
        return super().load_state_dict(sd, strict=strict, assign=assign)


def build_detector(cfg: DetectorConfig, device="cuda", state_dict=None,
                   seed: int = 0) -> ToC3DDetector:
    """The detector on ``device``, with weights from ``state_dict`` or, when
    none is given, random weights drawn from a generator seeded by
    ``seed``."""
    return build_module(lambda: ToC3DDetector(cfg), device, state_dict, seed,
                        init_weights_)


def build_module(make, device="cuda", state_dict=None, seed: int = 0,
                 init=None) -> nn.Module:
    """``make()`` built on ``device`` in eval mode, with the weights of
    ``state_dict`` (loaded strictly) or random weights drawn by
    ``init(module, generator)`` (init_module_weights_ by default) from a
    generator seeded by ``seed``."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        (init or init_module_weights_)(module, g)
    return module.eval()


def _uniform_(t, bound, g):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def _trunc_normal_(t, std, g):
    """Normal(0, std) truncated to +-2 std (layers.py:30-32)."""
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=g)
        bad = t.abs() > 2.0
        while bool(bad.any()):
            t[bad] = torch.randn(int(bad.sum()), device=t.device,
                                 dtype=t.dtype, generator=g)
            bad = t.abs() > 2.0
        t.mul_(std)


@torch.no_grad()
def init_module_weights_(model: nn.Module, g: torch.Generator) -> None:
    """The JAX package's default init distributions (layers.py:30-78) on
    every Linear, convolution, norm, Embedding, MLN and MultiheadAttention
    of ``model``: torch's kaiming-uniform with fan_in = kh * kw * c_in
    (ConvTranspose2d too), norms at weight 1 and bias 0, frozen BatchNorm
    statistics at mean 0 and variance 1."""
    from ..layers import MLN
    from ..ops.attention import MultiheadAttention
    from .common import LayerNorm2d
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = mod.weight[0].numel()
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
            _uniform_(mod.weight, math.sqrt(3.0 / fan_in), g)
            if mod.bias is not None:
                _uniform_(mod.bias, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, LayerNorm2d,
                              nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.fill_(0.0)
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            mod.weight.uniform_(0.0, 1.0, generator=g)
    for mod in model.modules():
        if isinstance(mod, MLN):
            mod.gamma.weight.zero_()
            mod.gamma.bias.fill_(1.0)
            mod.beta.weight.zero_()
            mod.beta.bias.zero_()
        elif isinstance(mod, MultiheadAttention):
            c = mod.in_proj_weight.shape[1]
            _uniform_(mod.in_proj_weight, math.sqrt(6.0 / (2 * c)), g)
            mod.in_proj_bias.zero_()


@torch.no_grad()
def init_head_weights_(head: StreamPETRHead, g: torch.Generator) -> None:
    """The head's own init after init_module_weights_
    (streampetr_head.py:130-176): xavier-uniform FFN weights with zero
    biases, the classifier's prior-probability bias."""
    from ..layers import bias_init_with_prob
    for layer in head.transformer.decoder.layers:
        for lin_ in (layer.ffns[0].layers[0][0], layer.ffns[0].layers[1]):
            fi, fo = lin_.in_features, lin_.out_features
            _uniform_(lin_.weight, math.sqrt(6.0 / (fi + fo)), g)
            lin_.bias.zero_()
    head.cls_branches[0][6].bias.fill_(bias_init_with_prob(0.01))


def _init_vit_(bb: nn.Module, g: torch.Generator) -> None:
    """The EVA-02 backbone's own init (eva_vit.py:96-118): pos_embed and
    the blocks' matrices truncated normal at 0.02, their biases zero."""
    if hasattr(bb, "pos_embed"):
        _trunc_normal_(bb.pos_embed, 0.02, g)
    for blk in bb.blocks:
        a, m = blk.attn, blk.mlp
        for lin_ in (a.q_proj, a.k_proj, a.v_proj, a.proj, m.w1, m.w2, m.w3):
            _trunc_normal_(lin_.weight, 0.02, g)
            if lin_.bias is not None:
                lin_.bias.zero_()
        a.q_bias.zero_()
        a.v_bias.zero_()


@torch.no_grad()
def init_weights_(model: ToC3DDetector, g: torch.Generator) -> None:
    """Random weights with the JAX package's init distributions
    (layers.py:30-78, eva_vit.py:96-118, streampetr_head.py:130-176); a
    VoVNet backbone takes init_module_weights_'s alone (vovnet.py)."""
    from ..layers import bias_init_with_prob
    init_module_weights_(model, g)
    if model.cfg.is_vit:
        _init_vit_(model.img_backbone, g)
    init_head_weights_(model.pts_bbox_head, g)
    roi = model.img_roi_head
    roi.cls.bias.fill_(bias_init_with_prob(0.01))
    roi.centerness.bias.fill_(bias_init_with_prob(0.01))


def init_state(batch_size: int, cfg: DetectorConfig,
               device="cuda") -> DetectorState:
    return DetectorState(memory=init_memory(batch_size, cfg.head, device))


def frame_tensors(frame):
    """numpy / tensor frame dict -> tensors where they lie (uint8 images
    stay uint8, everything else float32)."""
    out = {}
    for k, v in frame.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t if t.dtype == torch.uint8 else t.float()
    return out


def frame_to_device(frame, device="cuda"):
    """numpy / tensor frame dict -> tensors on ``device`` (uint8 images
    stay uint8, everything else float32). A tensor already there is taken
    as it is; one in pinned host memory is copied without blocking the
    host, so leave it unchanged until the frame has run."""
    device = torch.device(device)
    out = frame_tensors(frame)
    for k, t in out.items():
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            out[k] = t.to(device, non_blocking=True)
    return out


def synthetic_frame(g: torch.Generator, t: int, batch: int = 1,
                    views: int = 6, height: int = 800, width: int = 1600,
                    device="cuda"):
    """Frame ``t`` of a synthetic stream for smoke runs and timing: random
    uint8 views drawn from ``g``, a fixed pinhole rig (focal 1260) with
    seeded jitter on img2lidar, an ego pose that turns 0.05 rad and moves
    2 m per frame, timestamps 0.5 s apart, prev_exists 0 at t == 0 and 1
    after."""
    b, n = batch, views
    intr = torch.eye(4, device=device).repeat(b, n, 1, 1)
    intr[..., 0, 0] = intr[..., 1, 1] = 1260.0
    i2l = torch.eye(4, device=device).repeat(b, n, 1, 1)
    i2l = i2l + 0.01 * torch.randn(b, n, 4, 4, device=device, generator=g)
    ang = 0.05 * t
    ego = torch.eye(4, device=device).repeat(b, 1, 1)
    ego[:, 0, 0] = ego[:, 1, 1] = math.cos(ang)
    ego[:, 0, 1], ego[:, 1, 0] = -math.sin(ang), math.sin(ang)
    ego[:, 0, 3] = 2.0 * t
    return {
        "img": torch.randint(0, 256, (b, n, height, width, 3), device=device,
                             generator=g, dtype=torch.uint8),
        "intrinsics": intr, "img2lidar": i2l,
        "timestamp": torch.full((b,), 0.5 * t, device=device),
        "ego_pose": ego, "ego_pose_inv": torch.linalg.inv(ego),
        "prev_exists": torch.full((b,), 0.0 if t == 0 else 1.0,
                                  device=device),
    }


def _motion_ctx_from_memory(cfg: DetectorConfig, memory: MemoryBank, frame):
    """First pruning_num_queries bank slots: the selectors' guidance
    (petr3d.py:117-143)."""
    nq = cfg.backbone.pruning_num_queries
    return {
        "temp_queries": memory.embedding[:, :nq],
        "temp_ref_points": memory.reference_point[:, :nq],
        "temp_vel": memory.velo[:, :nq],
        "temp_timestamp": memory.timestamp[:, :nq],
        "temp_ego_pose": memory.egopose[:, :nq],
        "ego_pose_inv": frame["ego_pose_inv"],
    }


def _view_chunks(t, b: int, nc: int):
    """(B*N, ...) rows, b-major -> nc chunks of (B*N/nc, ...) rows, each
    b-major within itself (detector.py:166-170): the selector broadcasts
    the B-leading motion queries over bn // b contiguous rows. Each chunk
    is a contiguous copy, as the kernels take their input."""
    r = t.reshape((b, nc, -1) + t.shape[1:])
    return [r[:, i].reshape((-1,) + t.shape[1:]).contiguous()
            for i in range(nc)]


def _unchunk_views(chunks, b: int):
    """The inverse of _view_chunks: the chunks' rows back in b-major order
    (detector.py:188-196)."""
    st = torch.stack([c.reshape((b, -1) + c.shape[1:]) for c in chunks], 1)
    return st.reshape((-1,) + st.shape[3:])


def extract_img_feat(model: ToC3DDetector, img, memory: MemoryBank, frame,
                     steady=None, collect_block_outs: bool = False,
                     quant=None, mask_noise=None, train: bool = False,
                     dp_keep=None, remat: bool = False, view_scan=False,
                     attn_chunk=None):
    """img (B, N, H, W, 3) -> neck features (B, N, h, w, C) float32. A uint8
    image is normalized here, on the device (detector.py:142-150). The
    backbone is toc3d_vit_forward, guided by the memory bank, when the
    config compresses tokens (is_toc3d), eva_vit_forward for the plain
    EVA-02 (detector.py:206-230), and vovnet_forward for a VoVNet, whose
    two output levels the neck takes (inference only: train, view_scan and
    collect_block_outs raise); the neck runs in the stage span "neck".
    collect_block_outs: also return the ToC3D
    backbone's per-block inputs, outputs and scores (toc3d_vit_forward);
    quant overrides the backbone's cfg.quant ('none': the float blocks, as
    calibration runs them); mask_noise: the selectors' Gumbel noise for
    eval_mask 'gumbel' (MaskNoise), or training's. train (detector.py:
    100-240 with an rng; runtime/train.compute_losses): the backbones'
    training forward with the stochastic-depth keep masks dp_keep and
    remat; returns (features, {'token_masks': [...]}).

    view_scan (detector.py:104-200): True or an int cs that divides N (else
    ValueError): the backbone runs over N / cs chunks of B x cs views (True:
    cs 1), each chunk's rows b-major, and the features and token masks are
    put back in b-major order before the neck. The backbone never mixes
    views, so it is the same function: each chunk reads its own rows of
    mask_noise and dp_keep, and each Function's and checkpoint's backward
    recomputes only its chunk's rows, which bounds the backward's
    transients. attn_chunk: the model path's attention over chunks of that
    many windows (ops/attention.py)."""
    from ..configs.presets import IMG_NORM_MEAN, IMG_NORM_STD
    cfg = model.cfg
    b, n, h, w, c = img.shape
    x = img.reshape(b * n, h, w, c)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    if x.dtype == torch.uint8:
        mean = const_vector(IMG_NORM_MEAN, torch.float32, x.device)
        std = const_vector(IMG_NORM_STD, torch.float32, x.device)
        x = (x.float() - mean) / std
    x = x.to(dtype).contiguous()
    if train or view_scan or collect_block_outs:
        require_vit(cfg, "training, view_scan and the collected forward")
    if collect_block_outs and (view_scan or not cfg.is_toc3d):
        # as JAX's extract_img_feat (detector.py:155-159, :221-224), which
        # the static int8 calibration reaches through its collected forward
        raise NotImplementedError(
            "collecting block outputs targets the unscanned ToC3D backbone; "
            "the plain EVA-02 backbone and view_scan have no collected "
            "forward")
    motion_ctx = _motion_ctx_from_memory(cfg, memory, frame) \
        if cfg.is_toc3d else None

    def backbone(xs, noise, keep):
        if not cfg.is_vit:
            return vovnet_forward(model.img_backbone, xs), {"token_masks": []}
        if cfg.is_toc3d:
            out = toc3d_vit_forward(
                model.img_backbone, xs, motion_ctx, frame["prev_exists"],
                steady=steady, collect_block_outs=collect_block_outs,
                quant=quant, mask_noise=noise, train=train, dp_keep=keep,
                remat=remat, attn_chunk=attn_chunk)
            return out if collect_block_outs or train \
                else (out, {"token_masks": []})
        return eva_vit_forward(model.img_backbone, xs, quant=quant,
                               train=train, dp_keep=keep, remat=remat,
                               attn_chunk=attn_chunk), {"token_masks": []}

    if view_scan:
        cs = 1 if view_scan is True else int(view_scan)
        if n % cs:
            raise ValueError(
                f"view_scan chunk {cs} must divide the view count {n}")
        nc = n // cs
        if cfg.is_toc3d and steady is None:
            steady = is_steady(frame)
        rows = lambda t: _view_chunks(t, b, nc)
        noise = None if mask_noise is None else [rows(t) for t in mask_noise]
        keep = {i: [rows(k) for k in pair]
                for i, pair in (dp_keep or {}).items()}
        outs = [backbone(xc, None if noise is None else [t[j] for t in noise],
                         {i: (k0[j], k1[j]) for i, (k0, k1) in keep.items()})
                for j, xc in enumerate(rows(x))]
        feats = _unchunk_views([o[0] for o in outs], b)
        collected = {"token_masks": [
            _unchunk_views(list(ms), b)
            for ms in zip(*(o[1]["token_masks"] for o in outs))]}
    else:
        feats, collected = backbone(x, mask_noise, dp_keep)
    with stage("neck"):
        f = cpfpn_forward(model.img_neck, feats, cfg.neck,
                          train=train)[cfg.position_level]
    f = f.reshape(b, n, f.shape[1], f.shape[2], -1).float()
    return (f, collected) if collect_block_outs or train else f


def head_step(model: ToC3DDetector, state: DetectorState, feats, frame):
    """Head + decode given neck features (detector.py:275-288)."""
    cfg = model.cfg
    data = {k: frame[k] for k in ("intrinsics", "img2lidar", "timestamp",
                                  "ego_pose", "ego_pose_inv", "prev_exists")}
    data["pad_shape"] = cfg.pad_shape
    outs, memory = head_forward(model.pts_bbox_head, cfg.head, feats, data,
                                state.memory)
    dec = nms_free_decode(outs["all_cls_scores"], outs["all_bbox_preds"],
                          cfg.head.num_classes, cfg.head.max_decode,
                          cfg.head.post_center_range)
    return DetectorState(memory), dec._replace(
        bboxes=to_bottom_center(dec.bboxes))


@torch.no_grad()
def infer_step(model: ToC3DDetector, state: DetectorState, frame,
               timer=None, mask_noise=None):
    """(state, frame) -> (state', DecodedBoxes) (detector.py:243-272),
    eagerly. The frame's arrays may lie on the host (numpy or tensors) or
    on the model's device; host ones are moved there (frame_to_device).
    ``timer`` (runtime/timer.StageTimer): the spans "inputs",
    "backbone+neck" and "head+decode", and their stages
    "backbone+neck/select" (each token selector) and
    "head+decode/decoder", are recorded on it. mask_noise: the
    selectors' Gumbel noise under eval_mask 'gumbel' (MaskNoise.draw; none:
    the noiseless mask)."""
    steady = is_steady(frame)
    with span(timer, "inputs"):
        frame = frame_to_device(frame, next(model.parameters()).device)
    with span(timer, "backbone+neck"):
        feats = extract_img_feat(model, frame["img"], state.memory, frame,
                                 steady=steady, mask_noise=mask_noise)
    with span(timer, "head+decode"):
        return head_step(model, state, feats, frame)


@torch.no_grad()
def infer_step_with_aux(model: ToC3DDetector, state: DetectorState, frame):
    """infer_step that also returns the token selectors' masks, for the
    token visualizer (detector.py:409-427; petr3d.py:562-579): (state',
    DecodedBoxes, {"token_masks": [(B*N, h, w, 1) per selector]}), eagerly,
    through the collected forward of toc3d_vit_forward. The ToC3D backbone
    only; the mask is the noiseless one, as JAX's without a mask_rng."""
    steady = is_steady(frame)
    frame = frame_to_device(frame, next(model.parameters()).device)
    feats, collected = extract_img_feat(model, frame["img"], state.memory,
                                        frame, steady=steady,
                                        collect_block_outs=True)
    state, det = head_step(model, state, feats, frame)
    return state, det, {"token_masks": collected["token_masks"]}


@torch.no_grad()
def precast_backbone_(model: ToC3DDetector) -> None:
    """Cast the backbone's and the neck's weights to the compute dtype once
    (detector.py:291-340). The ViT blocks' and the patch embedding's
    matrices go into the kernels' packed copies in the compute dtype
    (pack_block_weights, pack_patch_weight), built here and kept on the
    modules (every pack a frame reads: runtime/export traces with them as
    they stand); in bf16 the score predictors' matrices are cast in place.
    Biases, LN parameters and pos_embed stay f32; the cast is the same
    rounding the per-call casts would do. Every convolution of a VoVNet
    backbone and of the neck goes into its pack (ops/cuda/conv.pack_conv:
    the compute dtype, channels-last, a VoVNet BatchNorm folded in).

    int8 serving (cfg.backbone.quant 'int8', a ViT): the blocks' int8 packs
    instead (pack_block_weights_int8, static activation scales where
    attach_act_scales put them, else dynamic); with cfg.head.decoder.quant
    'int8' also the decoder linears' int8 packs (quantize_decoder_params).
    The kernels take bf16 activations only, so int8 on the card needs
    compute_dtype 'bfloat16'."""
    from .petr_transformer import quantize_decoder_params
    cfg = model.cfg
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    if cfg.is_vit:
        _precast_vit(model)
    else:
        pack_vovnet(model.img_backbone, dtype)
    pack_cpfpn(model.img_neck, dtype)
    if cfg.head.decoder.quant == "int8":
        quantize_decoder_params(model.pts_bbox_head.transformer.decoder)


def _precast_vit(model: ToC3DDetector) -> None:
    """precast_backbone_'s ViT part: the patch embedding's, the blocks' and
    (in bf16) the score predictors' weights."""
    from ..ops.cuda.patch_embed import pack_patch_weight
    from ..ops.cuda.vit_block import (pack_block_weights,
                                      pack_block_weights_int8)
    cfg = model.cfg
    bb = model.img_backbone
    bf16 = cfg.compute_dtype == "bfloat16"
    int8 = cfg.backbone.quant == "int8"
    if int8 and not bf16 and bb.patch_embed.proj.weight.device.type != "cpu":
        raise ValueError("int8 serving on the card needs compute_dtype "
                         "'bfloat16' (the int8 kernels take bf16 "
                         "activations)")
    dtype = torch.bfloat16 if bf16 else torch.float32
    pack_patch_weight(bb.patch_embed.proj, dtype)
    if bf16:
        for sel in getattr(bb, "score_predictor", ()):
            for p in sel.parameters():
                if p.dim() >= 2 and p.dtype == torch.float32:
                    p.data = p.data.to(dtype)
    for blk in bb.blocks:
        if int8:
            pack_block_weights_int8(blk, cfg.backbone.num_heads, dtype)
        else:
            pack_block_weights(blk, cfg.backbone.num_heads, dtype)


def frame_seed(mask_seed: int, t: int) -> int:
    """A 63-bit seed for frame t of a stream seeded by mask_seed (a
    splitmix64 mix of the pair, whose low 32 bits, all that a CPU generator
    keeps, depend on both)."""
    m = 2 ** 64 - 1
    x = (mask_seed * 0x9E3779B97F4A7C15 + t) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) >> 1


class MaskNoise:
    """The selectors' Gumbel noise of eval_mask 'gumbel', frame by frame
    (detector.py:369-406 folds the frame counter into PRNGKey(mask_seed)
    and toc3d_vit.py:266-270 splits one key per selector). Frame t draws
    from one explicit generator on the model's device, seeded from
    (mask_seed, t), one f32 (B*N, h*w, 2) tensor per selector in selector
    order; the global generator is never used. ``active`` is False, and
    ``draw`` returns None, unless the model compresses tokens under
    eval_mask 'gumbel'."""

    def __init__(self, model: ToC3DDetector, mask_seed: int = 0):
        cfg = model.cfg
        self.active = cfg.is_toc3d and cfg.backbone.eval_mask == "gumbel"
        self.selectors = len(cfg.backbone.pruning_loc) if self.active else 0
        self.patch = cfg.backbone.patch_size if self.active else None
        self.seed = mask_seed
        self.counter = 0
        self.generator = torch.Generator(
            device=next(model.parameters()).device) if self.active else None

    def shape(self, img_shape):
        b, n, h, w = img_shape[:4]
        return (b * n, (h // self.patch) * (w // self.patch), 2)

    def draw(self, img_shape, out=None):
        """The next frame's noise for images of ``img_shape`` (B, N, H, W,
        3): written into ``out`` (one f32 buffer per selector) when given,
        else into new tensors; None when inactive."""
        if not self.active:
            return None
        self.generator.manual_seed(frame_seed(self.seed, self.counter))
        self.counter += 1
        if out is None:
            out = [torch.empty(self.shape(img_shape), dtype=torch.float32,
                               device=self.generator.device)
                   for _ in range(self.selectors)]
        for t in out:
            gumbel_(t, self.generator)
        return out


def eager_infer_fn(model: ToC3DDetector, timer=None, mask_seed: int = 0):
    """``infer(state, frame)``: ``infer_step`` on ``model`` with ``timer``,
    after casting (or, for int8, quantizing) the weights once
    (precast_backbone_); under eval_mask 'gumbel' each frame draws its
    noise from ``mask_seed`` (MaskNoise)."""
    precast_backbone_(model)
    noise = MaskNoise(model, mask_seed)

    def infer(state: DetectorState, frame):
        return infer_step(model, state, frame, timer,
                          noise.draw(frame["img"].shape))
    return infer


def make_infer_fn(model: ToC3DDetector, timer=None, mask_seed: int = 0):
    """Streaming inference callable ``infer(state, frame) -> (state',
    DecodedBoxes)`` (detector.py:369-406). Casts (or, for int8 serving,
    quantizes) the weights once (precast_backbone_); to serve static int8,
    attach calibrated scales first (ops/int8_calib.attach_act_scales).
    mask_seed: under eval_mask 'gumbel', frame t's noise comes from
    (mask_seed, t) (MaskNoise), the same in both forms below.

    On a CUDA model the frame runs as captured CUDA graphs, the
    counterpart of JAX's two jitted programs (runtime/graphs.CapturedInfer:
    backbone + neck, for the ToC3D backbone one graph per value of steady,
    and head + decode); a capture that fails raises. On the CPU it runs
    ``infer_step`` eagerly (``eager_infer_fn``). ``timer``
    (runtime/timer.StageTimer): the spans "inputs", "backbone+neck" and
    "head+decode" and their stages (``infer_step``) are recorded on it."""
    if next(model.parameters()).is_cuda:
        from ..runtime.graphs import CapturedInfer
        return CapturedInfer(model, timer, mask_seed)
    return eager_infer_fn(model, timer, mask_seed)


__all__ = ["DetectorConfig", "DetectorState", "DecodedBoxes",
           "FocalHeadConfig", "ToC3DDetector", "build_detector",
           "build_backbone", "require_vit",
           "init_state", "infer_step", "infer_step_with_aux", "head_step",
           "extract_img_feat",
           "make_infer_fn", "eager_infer_fn", "precast_backbone_",
           "MaskNoise", "frame_to_device", "frame_tensors", "is_steady",
           "synthetic_frame"]
