"""EVA-02 ViT backbone (counterpart of toc3d_tpu/models/eva_vit.py;
reference eva_vit.py, eva_utils.py): the plain backbone that the StreamPETR
presets run, and the pieces the ToC3D backbone (models/toc3d_vit.py) shares.

Modules carry the reference (mmdet3d) parameter names, so a reference state
dict loads into them directly. The block forward runs kernel B
(ops/cuda/vit_block.fused_full_block; B8, fused_full_block_int8, with
quant='int8') and the patch embedding kernel A
(ops/cuda/patch_embed.patchify_matmul), each as its autograd Function
(ops/trainable.py). In training (``train=True``) a block with stochastic
depth runs the model path instead, as JAX's does (injectable_sites).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch
import torch.nn as nn

from torch.utils.checkpoint import checkpoint

from ..ops.cuda.int8 import SITES
from ..ops.cuda.vit_block import fused_full_block_int8
from ..ops.resize import resize_abs_pos
from ..ops.rope import build_rope_table
from ..ops.trainable import (full_block_model, trainable_full_block,
                             trainable_patch_embed)

LN_EPS = 1e-6


@dataclass(frozen=True)
class EVAViTConfig:
    """Field names of toc3d_tpu/models/eva_vit.py:35-72 that inference reads.
    Left out: fused_blocks (the port always runs its kernels on the card).
    quant 'int8': serving int8 blocks (kernels B8 / C8), their weights
    quantized once by detector.precast_backbone_; activations quantized per
    row, or at static scales where calibrated ones are attached
    (ops/int8_calib.attach_act_scales)."""
    img_size: int = 320
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4 * 2 / 3
    window_size: int = 16
    global_window_size: int = 20
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11, 14, 17, 20, 23)
    use_abs_pos: bool = True
    rope: bool = True
    pt_hw_seq_len: int = 16
    intp_freq: bool = True
    pretrain_img_size: int = 224
    pretrain_use_cls_token: bool = True
    drop_path_rate: float = 0.0   # training only; the eval path ignores it
    quant: str = "none"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hw_seq_len(self) -> int:
        return self.img_size // self.patch_size


def make_rope_tables(cfg: EVAViTConfig):
    """(window_tables, global_tables), each a (cos, sin) pair of float32
    numpy arrays, or (None, None) without RoPE (eva_vit.py:80-89)."""
    if not cfg.rope:
        return None, None
    half = cfg.head_dim // 2
    win = build_rope_table(half, cfg.pt_hw_seq_len,
                           cfg.window_size if cfg.intp_freq else None)
    glb = build_rope_table(half, cfg.pt_hw_seq_len,
                           cfg.hw_seq_len if cfg.intp_freq else None)
    return win, glb


class Attention(nn.Module):
    """EVA attention parameters (reference eva_vit.py:54-119): q/k/v
    projections without bias, separate q_bias and v_bias, output proj."""

    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)


class SwiGLU(nn.Module):
    """SwiGLU with sub-LN (reference eva_vit.py:27-51)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = nn.LayerNorm(hidden, eps=LN_EPS)
        self.w3 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """One EVA-02 block's parameters (reference eva_vit.py:226-266)."""

    def __init__(self, cfg: EVAViTConfig):
        super().__init__()
        c = cfg.embed_dim
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = SwiGLU(c, int(c * cfg.mlp_ratio))


def set_act_scales(blk: Block, scales) -> None:
    """Attach to ``blk`` its four calibrated static activation scales (a
    {site: scale} dict or a sequence in SITES order), as the persistent
    buffer ``act_scales`` (4,) f32, or drop them with None. The int8 pack
    (vit_block.pack_block_weights_int8) quantizes with them when present."""
    if scales is None:
        blk._buffers.pop("act_scales", None)
        return
    if isinstance(scales, dict):
        scales = [scales[k] for k in SITES]
    t = torch.as_tensor([float(v) for v in scales], dtype=torch.float32)
    blk.register_buffer("act_scales", t.to(blk.norm1.weight.device))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EVAViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)


def patch_embed(pe: PatchEmbed, x, patch_size: int):
    """x: (B, H, W, 3) normalized -> (B, H/ps, W/ps, C) in x.dtype, through
    kernel A (eva_vit.py:149-173; PatchEmbedFn)."""
    if x.shape[1] % patch_size or x.shape[2] % patch_size:
        raise ValueError(f"image size {tuple(x.shape[1:3])} must be a "
                         f"multiple of patch_size={patch_size}")
    return trainable_patch_embed(pe.proj, x, patch_size)


def block_forward(blk: Block, x, cfg: EVAViTConfig, window_size: int,
                  rope_tables, dp_rate: float = 0.0, dp_keep=None,
                  remat: bool = False):
    """Plain (non-compressed) EVA block, x: (B, H, W, C), through kernel B
    (FullBlockFn; B8 with cfg.quant 'int8'). rope_tables: (cos, sin)
    tensors on x's device, or None. dp_rate > 0 (training, a block with
    stochastic depth): the model path with the residuals' keep masks
    ``dp_keep`` ((B,), (B,)), under torch.utils.checkpoint with remat
    (eva_vit.py:221-266)."""
    if cfg.quant == "int8":
        return fused_full_block_int8(blk, x, cfg.num_heads, window_size,
                                     rope_tables)
    if dp_rate <= 0.0:
        return trainable_full_block(blk, x, cfg.num_heads, window_size,
                                    rope_tables)
    args = (blk, x, cfg.num_heads, window_size, rope_tables, dp_keep,
            dp_rate)
    return checkpoint(full_block_model, *args, use_reentrant=False) \
        if remat else full_block_model(*args)


def rope_tensors(tables, device):
    """numpy (cos, sin) pair -> float32 tensors on ``device`` (or None)."""
    if tables is None:
        return None
    return tuple(torch.from_numpy(t).to(device) for t in tables)


class EVAViT(nn.Module):
    """Plain EVA-02 backbone parameters with the reference names:
    patch_embed.proj, pos_embed, blocks.{i} (eva_vit.py:107-118); a
    StreamPETR state dict has no score_predictor."""

    def __init__(self, cfg: EVAViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        if cfg.use_abs_pos:
            n = (cfg.pretrain_img_size // cfg.patch_size) ** 2
            n = n + 1 if cfg.pretrain_use_cls_token else n
            self.pos_embed = nn.Parameter(torch.zeros(1, n, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))

    def rope(self, device):
        """(window, global) RoPE tables as f32 tensors on ``device``."""
        cache = self.__dict__.setdefault("_rope_cache", {})
        if device not in cache:
            win, glb = make_rope_tables(self.cfg)
            cache[device] = (rope_tensors(win, device),
                             rope_tensors(glb, device))
        return cache[device]


def embed(model: EVAViT, x, cfg: EVAViTConfig):
    """Kernel A, then the bicubic-resized absolute position embedding
    (eva_vit.py:317-321)."""
    x = patch_embed(model.patch_embed, x, cfg.patch_size)
    if cfg.use_abs_pos:
        x = x + resize_abs_pos(model.pos_embed, cfg.pretrain_use_cls_token,
                               (x.shape[1], x.shape[2])).to(x.dtype)
    return x


def drop_path_rates(cfg: EVAViTConfig):
    """The linear stochastic-depth ramp over the blocks (eva_vit.py:
    291-296)."""
    if cfg.depth == 1:
        return [0.0]
    return [cfg.drop_path_rate * i / (cfg.depth - 1)
            for i in range(cfg.depth)]


def eva_vit_forward(model: EVAViT, x, quant=None, train: bool = False,
                    dp_keep=None, remat: bool = False):
    """x (B, H, W, 3) normalized images in the compute dtype -> features
    (B, h, w, C) (eva_vit.py:302-334): kernel A, the position embedding,
    then ``depth`` blocks through kernel B (B8 with quant 'int8'), at
    window_size or, at global_attn_indexes, global_window_size. quant
    overrides cfg.quant. train: the blocks with stochastic depth run the
    model path with their keep masks dp_keep ({block index: masks})."""
    cfg = model.cfg if quant is None else replace(model.cfg, quant=quant)
    rope_win, rope_glb = model.rope(x.device)
    x = embed(model, x, cfg)
    dprs = drop_path_rates(cfg) if train else [0.0] * cfg.depth
    for i, blk in enumerate(model.blocks):
        is_global = i in cfg.global_attn_indexes
        x = block_forward(
            blk, x, cfg,
            cfg.global_window_size if is_global else cfg.window_size,
            rope_glb if is_global else rope_win, dprs[i],
            (dp_keep or {}).get(i), remat)
    return x
