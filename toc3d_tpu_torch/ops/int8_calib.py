"""Static activation-scale calibration for the int8 serving path
(counterpart of toc3d_tpu/ops/int8_calib.py).

The int8 blocks (kernels B8 / C8, ops/cuda/vit_block.py) quantize their
activations per row at run time, unless a block carries calibrated static
scales: then each of its four quantization sites (ops/cuda/int8.SITES)
quantizes at one fixed scale. Calibration measures each block's site
maxima over a few frames, on the float weights, and keeps amax / 127:

  attn_in  post-LN1 tokens (input of the QKV matmul),
  proj_in  the merged attention output before the O-projection,
  mlp_in   post-LN2 tokens (input of the SwiGLU w1/w2 matmul),
  ffn_in   the post-sub-LN hidden (input of w3).

The probes recompute those sites with plain torch math (the JAX probes are
XLA math, int8_calib.py:50-139), driven by each block's input from one
collected float forward (toc3d_vit_forward(collect_block_outs=True)).

    scales = calibrate_act_scales(model, frames)   # float weights
    attach_act_scales(model, scales)
    infer = make_infer_fn(model)   # cfg quant 'int8': static B8 / C8

Static calibration covers the ToC3D backbone only, as in JAX: its collected
forward (extract_img_feat(collect_block_outs=True)) raises
NotImplementedError for the plain backbone of the StreamPETR presets, which
serve int8 with dynamic scales (B8 with per-row quantization).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..layers import lin, ln
from .attention import eva_attention_preproj
from .cuda.int8 import SITES
from .gather import batch_index_select, merge_tokens
from .window import window_partition, window_unpartition

LN_EPS = 1e-6


def _amax(t):
    return t.float().abs().amax()


def _swiglu_sites(mlp, x2):
    """mlp_in / ffn_in amaxes given the post-LN2 tokens x2."""
    hidden = F.silu(lin(mlp.w1, x2)) * lin(mlp.w2, x2)
    hidden = ln(mlp.ffn_ln, hidden, LN_EPS)
    return _amax(x2), _amax(hidden)


def full_block_site_amax(blk, x, num_heads: int, ws: int, tables):
    """Site amaxes (4,) of one full block (eva_vit.Block) on x (B, H, W,
    C), in SITES order (int8_calib.py:82-97). tables: (cos, sin) or None."""
    b, h, w, c = x.shape
    xw, padded = window_partition(ln(blk.norm1, x, LN_EPS), ws)
    nwin = xw.shape[0]
    xw = xw.reshape(nwin, ws * ws, c)
    a_attn = _amax(xw)
    o = eva_attention_preproj(blk.attn, xw, num_heads, tables)
    a_proj = _amax(o)
    ow = lin(blk.attn.proj, o).reshape(nwin, ws, ws, c)
    x = x + window_unpartition(ow, ws, padded, (h, w))
    a_mlp, a_ffn = _swiglu_sites(blk.mlp, ln(blk.norm2, x, LN_EPS))
    return torch.stack([a_attn, a_proj, a_mlp, a_ffn])


def compressed_block_site_amax(blk, x, scores, cfg, ws: int, ratio: float,
                               tables):
    """Site amaxes (4,) of one token-compressed block on its k (+ 1
    representative) rows per window (int8_calib.py:100-139). cfg: the
    backbone's ToC3DViTConfig; scores (B, H*W)."""
    from ..models.token_select import keep_count, sample_topk
    bn, h, w, c = x.shape
    n = ws * ws
    xw, _ = window_partition(x, ws)
    sw, _ = window_partition(scores.reshape(bn, h, w, 1), ws, pad_value=-1e6)
    nw = xw.shape[0]
    xw = xw.reshape(nw, n, c)
    sw = sw.reshape(nw, n)
    k = keep_count(n, ratio, n_rep=1 if cfg.use_represent_tokens else 0,
                   mxu_align=cfg.mxu_align_k)
    _, fast_score, slow_idx, fast_idx = sample_topk(sw, ratio, k=k)
    slow = batch_index_select(xw, slow_idx)
    fast = batch_index_select(xw, fast_idx)
    use_rep = cfg.use_represent_tokens and fast.shape[1] > 0
    if use_rep:
        slow = torch.cat([slow, merge_tokens(fast, fast_score)], dim=1)
    sel_idx = None
    if cfg.rope and cfg.rope_acc and tables is not None:
        sel_idx = slow_idx
        if use_rep:
            sel_idx = torch.cat([slow_idx, torch.full_like(slow_idx[:, :1], k)],
                                dim=-1)
    else:
        tables = None
    hdn = ln(blk.norm1, slow, LN_EPS)
    a_attn = _amax(hdn)
    o = eva_attention_preproj(blk.attn, hdn, cfg.num_heads, tables, sel_idx)
    a_proj = _amax(o)
    slow = slow + lin(blk.attn.proj, o)
    a_mlp, a_ffn = _swiglu_sites(blk.mlp, ln(blk.norm2, slow, LN_EPS))
    return torch.stack([a_attn, a_proj, a_mlp, a_ffn])


@torch.no_grad()
def backbone_site_amax(model, frame, memory) -> np.ndarray:
    """Per-block site amaxes for one frame: one collected forward of the
    float blocks, then a probe per block (int8_calib.py:142-216). model:
    models.detector.ToC3DDetector; returns a (depth, 4) float64 array in
    SITES order."""
    from ..models.detector import extract_img_feat
    bcfg = model.img_backbone.cfg
    _, col = extract_img_feat(model, frame["img"], memory, frame,
                              collect_block_outs=True, quant="none")
    rope_win, rope_glb = model.img_backbone.rope(frame["img"].device)
    rows = []
    seg = -1
    for i in range(bcfg.depth):
        if i in bcfg.pruning_loc:
            seg += 1
        is_global = i in bcfg.global_attn_indexes
        ws = bcfg.global_window_size if is_global else bcfg.window_size
        tables = (rope_glb if is_global else rope_win) if bcfg.rope else None
        blk, x = model.img_backbone.blocks[i], col["inputs"][i]
        if bcfg.block_is_accelerated(i):
            row = compressed_block_site_amax(
                blk, x, col["scores"][i], bcfg, ws,
                bcfg.selector_config(seg).ratio, tables)
        else:
            row = full_block_site_amax(blk, x, bcfg.num_heads, ws, tables)
        rows.append(row.double().cpu().numpy())
    return np.stack(rows)


def calibrate_act_scales(model, frames, headroom: float = 1.0):
    """Static activation scales over the eval ``frames`` (dicts of tensors
    on the model's device, as infer_step takes), each from a fresh memory
    bank, on the model's float weights (int8_calib.py:219-240). Returns a
    per-block list of {site: f32 scale} with scale = max(running amax *
    headroom, 1e-6) / 127, ready for attach_act_scales."""
    from ..models.streampetr_head import init_memory
    running = None
    for frame in frames:
        memory = init_memory(frame["img"].shape[0], model.cfg.head,
                             frame["img"].device)
        amax = backbone_site_amax(model, frame, memory)
        running = amax if running is None else np.maximum(running, amax)
    if running is None:
        raise ValueError("calibration needs at least one frame")
    scales = np.maximum(running * headroom, 1e-6) / 127.0
    return [dict(zip(SITES, row.astype(np.float32))) for row in scales]


def attach_act_scales(model, scales):
    """Attach per-block calibrated scales (calibrate_act_scales) to the
    backbone's blocks, where the int8 packs pick them up
    (int8_calib.py:243-254). Returns the model."""
    from ..models.eva_vit import set_act_scales
    blocks = model.img_backbone.blocks
    if len(scales) != len(blocks):
        raise ValueError(f"{len(scales)} scale sets for {len(blocks)} blocks")
    for blk, s in zip(blocks, scales):
        set_act_scales(blk, s)
    return model
