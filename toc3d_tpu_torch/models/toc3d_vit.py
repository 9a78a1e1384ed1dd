"""ToC3D EVA-ViT backbone: EVA-02 with motion query-guided token compression
(counterpart of toc3d_tpu/models/toc3d_vit.py; reference toc3d_eva_vit.py).

Blocks before the first pruning location are full blocks (kernel B); from
there on every block is token-compressed (kernel C), global blocks included
when accelerate_global is set. The keep count per window is a static
int(n * ratio) (with the mxu_align_k option), so every compressed block
works on a fixed (k + 1)-row set per window.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch
import torch.nn as nn

from ..ops.cuda.vit_block import fused_compressed_block_int8
from ..ops.trainable import trainable_compressed_block
from .eva_vit import (EVAViT, EVAViTConfig, Block, block_forward,
                      drop_path_rates, embed)
from .token_select import (SelectorConfig, Selector, hard_mask,
                           selector_score, soft_mask)


@dataclass(frozen=True)
class ToC3DViTConfig(EVAViTConfig):
    """Token-compression knobs of toc3d_tpu/models/toc3d_vit.py:38-89. An
    empty pruning_loc makes it a plain backbone (DetectorConfig.is_toc3d).
    eval_mask, the token mask each selector hands the next
    (toc3d_utils.py:146-157): 'softmax', the noiseless channel 0 of the
    gumbel-softmax; 'gumbel', with Gumbel noise (the reference's own eval
    mask, stochastic: make_infer_fn draws it from mask_seed); 'hard', the
    0/1 mask of the whole-image top-k."""
    pruning_loc: Tuple[int, ...] = (6, 12, 18)
    token_ratio: Tuple[float, ...] = (0.7, 0.5, 0.5)
    pruning_num_queries: int = 64
    pruning_score_type: str = "attention"
    pruning_attn_scale: bool = True
    score_mask: bool = True
    accelerate_global: bool = True
    use_represent_tokens: bool = True
    rope_acc: bool = True
    query_dim: int = 256
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    eval_mask: str = "softmax"
    # default True as in the JAX package (toc3d_vit.py:60-66): one kept token
    # fewer per window when k + 1 = 1 mod 128 (ws 16, ratio .5: 127 not 128)
    mxu_align_k: bool = True

    def __post_init__(self):
        overlap = set(self.pruning_loc) & set(self.global_attn_indexes)
        if overlap:
            raise ValueError("pruning layers cannot be global attention "
                             f"layers (toc3d_eva_vit.py:141-142): {overlap}")
        if len(self.token_ratio) < len(self.pruning_loc) or any(
                not 0 <= i < self.depth for i in self.pruning_loc):
            raise ValueError(
                f"pruning_loc {self.pruning_loc} must lie in [0, depth="
                f"{self.depth}) and have a token_ratio each "
                f"({self.token_ratio})")
        if self.eval_mask not in ("softmax", "gumbel", "hard"):
            raise ValueError(f"eval_mask {self.eval_mask!r}: 'softmax', "
                             "'gumbel' or 'hard'")

    def selector_config(self, i: int) -> SelectorConfig:
        return SelectorConfig(
            embed_dim=self.embed_dim, query_dim=self.query_dim,
            num_queries=self.pruning_num_queries,
            ratio=self.token_ratio[i], attn_scale=self.pruning_attn_scale,
            use_mask=self.score_mask, score_type=self.pruning_score_type,
            pc_range=self.pc_range)

    def block_is_accelerated(self, i: int) -> bool:
        if not self.pruning_loc or i < self.pruning_loc[0]:
            return False
        if i in self.global_attn_indexes:
            return self.accelerate_global
        return True


class ToC3DViT(EVAViT):
    """Backbone parameters with the reference names: patch_embed.proj,
    pos_embed, blocks.{i}, score_predictor.{j}."""

    def __init__(self, cfg: ToC3DViTConfig):
        super().__init__(cfg)
        self.score_predictor = nn.ModuleList(
            Selector(cfg.selector_config(i))
            for i in range(len(cfg.pruning_loc)))


def toc3d_block_forward(blk: Block, x, scores, cfg: ToC3DViTConfig,
                        window_size: int, ratio: float, rope_tables,
                        attn_chunk=None):
    """Slow/fast token routing inside one window-attention block through
    kernel C (C8 with cfg.quant 'int8'). x (BN, H, W, C); scores (BN, H*W)
    (toc3d_vit.py:113-177). attn_chunk: the backward's attention over
    chunks of that many windows (CompressedBlockFn; training)."""
    args = (blk, x, scores, cfg.num_heads, window_size, ratio,
            rope_tables if cfg.rope else None)
    kw = dict(use_represent=cfg.use_represent_tokens, rope_acc=cfg.rope_acc,
              align_k=cfg.mxu_align_k)
    if cfg.quant == "int8":
        return fused_compressed_block_int8(*args, **kw)
    return trainable_compressed_block(*args, **kw, attn_chunk=attn_chunk)


def toc3d_vit_forward(model: ToC3DViT, x, motion_ctx, prev_exists,
                      steady=None, collect_block_outs: bool = False,
                      quant=None, mask_noise=None, train: bool = False,
                      dp_keep=None, remat: bool = False, attn_chunk=None):
    """x (BN, H, W, 3) normalized images in the compute dtype -> features
    (BN, h, w, C) (toc3d_vit.py:196-369). motion_ctx: memory-bank views for
    the selectors; prev_exists (B,); steady: all(prev_exists > 0) if the
    caller already knows it. quant overrides cfg.quant ('none' runs the
    float blocks, as calibration does). mask_noise: one f32 Gumbel noise
    tensor (BN, h*w, 2) per selector, in selector order
    (toc3d_vit.py:266-270 splits one key per selector), read with eval_mask
    'gumbel' and in training; without it the mask is noiseless, as JAX's
    without a mask_rng. collect_block_outs: also return {'inputs': [x_i],
    'outputs': [y_i], 'scores': [scores or None]} per block
    (toc3d_vit.py:361-362), what ops.int8_calib probes, and 'token_masks':
    the (BN, h, w, 1) mask of each selector, in selector order (JAX's
    aux['token_masks'], toc3d_vit.py:284), what the token visualizer draws
    and the token-selection loss reads.

    train (JAX's forward with an rng): the reference's keep counts
    int(n * ratio), without serving's MXU alignment (toc3d_vit.py:223-231;
    k 128 at ws 16, ratio .5); the selectors' training blend and the
    gumbel-softmax mask of ``mask_noise``; the full blocks with stochastic
    depth on the model path with their keep masks dp_keep ({block index:
    masks}), under torch.utils.checkpoint with remat (injectable_sites,
    toc3d_vit.py:184-193). Returns (features, {'token_masks': [...]}).
    attn_chunk: the model path's attention over chunks of that many
    windows, in the droppath blocks and in the Functions' backward
    (ops/attention.py)."""
    cfg = model.cfg
    if quant is not None:
        cfg = replace(cfg, quant=quant)
    if train:
        cfg = replace(cfg, mxu_align_k=False)
    rope_win, rope_glb = model.rope(x.device)
    x = embed(model, x, cfg)
    bn, h, w, c = x.shape
    masks = torch.ones(bn, h, w, 1, dtype=x.dtype, device=x.device)
    if steady is None:
        steady = bool((prev_exists > 0).all())
    dprs = drop_path_rates(cfg) if train else [0.0] * cfg.depth
    scores = None
    ratio = None
    seg = 0
    collected = {"inputs": [], "outputs": [], "scores": [],
                 "token_masks": []}
    for i in range(cfg.depth):
        if i in cfg.pruning_loc:
            scfg = cfg.selector_config(seg)
            scores, pred, _ = selector_score(
                model.score_predictor[seg], scfg, x, masks, motion_ctx,
                prev_exists, steady=steady, train_blend=train)
            if cfg.eval_mask == "hard" and not train:
                masks = hard_mask(scores, scfg.ratio).to(x.dtype)
            else:
                noise = None
                if (train or cfg.eval_mask == "gumbel") and \
                        mask_noise is not None:
                    noise = mask_noise[seg]
                masks = soft_mask(pred, noise)
            masks = masks.reshape(bn, h, w, 1)
            collected["token_masks"].append(masks)
            ratio = scfg.ratio
            seg += 1
        is_global = i in cfg.global_attn_indexes
        ws = cfg.global_window_size if is_global else cfg.window_size
        tables = rope_glb if is_global else rope_win
        accelerated = cfg.block_is_accelerated(i)
        if collect_block_outs:
            collected["inputs"].append(x)
            collected["scores"].append(scores if accelerated else None)
        if accelerated:
            x = toc3d_block_forward(model.blocks[i], x, scores, cfg, ws,
                                    ratio, tables, attn_chunk)
        else:
            x = block_forward(model.blocks[i], x, cfg, ws, tables, dprs[i],
                              (dp_keep or {}).get(i), remat, attn_chunk)
        if collect_block_outs:
            collected["outputs"].append(x)
    if collect_block_outs:
        return x, collected
    if train:
        return x, {"token_masks": collected["token_masks"]}
    return x
