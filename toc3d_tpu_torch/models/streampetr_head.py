"""StreamPETR head with an explicit temporal memory bank (counterpart of
toc3d_tpu/models/streampetr_head.py; reference streampetr_head.py:315-680).
Training adds the FocalHead's token order (``topk_indexes``), the DN
queries and their attention mask, explicit dropout masks and per-layer
checkpointing; its bank leaves detached, as JAX's train step detaches it.

As in the JAX package: the bank is an explicit object threaded between
frames and reset branchlessly by prev_exists; timestamps are f32 seconds
relative to a run origin; cls/reg branches are shared across decoder layers
(index 0 is canonical); per-view intrinsics are tiled with the reference's
``.repeat(1, H*W, 1)`` pairing (token j -> view j % N).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (MLN, SELinear, inverse_sigmoid, lin, ln, mlp_relu, mln,
                      se_linear)
from ..ops.consts import const_vector, device_const
from ..ops.gather import memory_refresh, topk_gather
from ..ops.posenc import (nerf_positional_encoding, pos2posemb1d,
                          pos2posemb3d)
from ..core.boxes import transform_reference_points
from ..core.state import MemoryBank
from ..runtime.timer import stage
from .petr_transformer import DecoderConfig, Transformer, decoder_forward

LN_EPS = 1e-5


@dataclass(frozen=True)
class StreamPETRHeadConfig:
    """Field names of streampetr_head.py:47-86; with_dn .. split,
    code_weights and dn_max_gt are read by training only (core/dn.py,
    models/streampetr_loss.py)."""
    num_classes: int = 10
    in_channels: int = 256
    embed_dims: int = 256
    stride: int = 16
    num_query: int = 644
    memory_len: int = 1024
    topk_proposals: int = 256
    num_propagated: int = 256
    with_ego_pos: bool = True
    with_dn: bool = True
    scalar: int = 10                  # number of denoising groups
    noise_scale: float = 1.0
    noise_trans: float = 0.0
    dn_weight: float = 1.0
    split: float = 0.75
    depth_num: int = 64
    depth_start: float = 1.0
    LID: bool = True
    position_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    code_size: int = 10
    code_weights: Tuple[float, ...] = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                                       1.0, 1.0, 1.0)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    max_decode: int = 300
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2,
                                            10.0)
    # static DN padding (the reference pads to the batch's max GT count)
    dn_max_gt: int = 96
    compute_dtype: str = "float32"

    @property
    def position_dim(self) -> int:
        return self.depth_num * 3


def init_memory(batch_size: int, cfg: StreamPETRHeadConfig,
                device="cuda") -> MemoryBank:
    b, l, c = batch_size, cfg.memory_len, cfg.embed_dims
    z = lambda *s: torch.zeros(*s, dtype=torch.float32, device=device)
    return MemoryBank(z(b, l, c), z(b, l, 3), z(b, l, 1), z(b, l, 4, 4),
                      z(b, l, 2))


def lid_depth_bins(cfg: StreamPETRHeadConfig) -> np.ndarray:
    """LID depth discretization (streampetr_head.py:113-123)."""
    index = np.arange(cfg.depth_num, dtype=np.float64)
    if cfg.LID:
        bin_size = (cfg.position_range[3] - cfg.depth_start) / (
            cfg.depth_num * (1 + cfg.depth_num))
        coords_d = cfg.depth_start + bin_size * index * (index + 1)
    else:
        bin_size = (cfg.position_range[3] - cfg.depth_start) / cfg.depth_num
        coords_d = cfg.depth_start + bin_size * index
    return coords_d.astype(np.float32)


class StreamPETRHead(nn.Module):
    """Head parameters with the reference names."""

    def __init__(self, cfg: StreamPETRHeadConfig):
        super().__init__()
        d = cfg.embed_dims
        self.position_encoder = nn.Sequential(
            nn.Linear(cfg.position_dim, d * 4), nn.ReLU(), nn.Linear(d * 4, d))
        self.memory_embed = nn.Sequential(
            nn.Linear(cfg.in_channels, d), nn.ReLU(), nn.Linear(d, d))
        self.featurized_pe = SELinear(d)
        self.reference_points = nn.Embedding(cfg.num_query, 3)
        if cfg.num_propagated > 0:
            self.pseudo_reference_points = nn.Embedding(cfg.num_propagated, 3)
        self.query_embedding = nn.Sequential(
            nn.Linear(d * 3 // 2, d), nn.ReLU(), nn.Linear(d, d))
        self.spatial_alignment = MLN(8, d)
        self.time_embedding = nn.Sequential(nn.Linear(d, d),
                                            nn.LayerNorm(d, eps=LN_EPS))
        if cfg.with_ego_pos:
            self.ego_pose_pe = MLN(180, d)
            self.ego_pose_memory = MLN(180, d)
        self.transformer = Transformer(cfg.decoder)
        # the reference aliases one module at every index; index 0 is the
        # one a checkpoint's weights are read from (the others are dropped
        # on load, as by runtime/checkpoint.convert_detector_checkpoint)
        self.cls_branches = nn.ModuleList([nn.Sequential(
            nn.Linear(d, d), nn.LayerNorm(d, eps=LN_EPS), nn.ReLU(),
            nn.Linear(d, d), nn.LayerNorm(d, eps=LN_EPS), nn.ReLU(),
            nn.Linear(d, cfg.num_classes))])
        self.reg_branches = nn.ModuleList([nn.Sequential(
            nn.Linear(d, d), nn.ReLU(), nn.Linear(d, d), nn.ReLU(),
            nn.Linear(d, cfg.code_size))])


def cls_branch_forward(br: nn.Sequential, x):
    x = F.relu(ln(br[1], lin(br[0], x), LN_EPS))
    x = F.relu(ln(br[4], lin(br[3], x), LN_EPS))
    return lin(br[6], x)


def reg_branch_forward(br: nn.Sequential, x):
    x = F.relu(lin(br[0], x))
    x = F.relu(lin(br[2], x))
    return lin(br[4], x)


def pre_update_memory(cfg: StreamPETRHeadConfig, head: StreamPETRHead,
                      bank: MemoryBank, timestamp, ego_pose_inv,
                      prev_exists) -> MemoryBank:
    """Align the bank into the current ego frame and reset it on a scene
    change (streampetr_head.py:195-224)."""
    x = prev_exists.to(bank.embedding.dtype)
    b = x.shape[0]
    ts = bank.timestamp + timestamp[:, None, None]
    ego = torch.einsum("bij,bljk->blik", ego_pose_inv, bank.egopose)
    ref = transform_reference_points(bank.reference_point, ego_pose_inv)
    ts, ref, ego = (memory_refresh(t, x) for t in (ts, ref, ego))
    emb = memory_refresh(bank.embedding, x)
    velo = memory_refresh(bank.velo, x)
    if cfg.num_propagated > 0:
        p = cfg.num_propagated
        pc = const_vector(cfg.pc_range, ref.dtype, ref.device)
        pseudo = (head.pseudo_reference_points.weight.detach().to(ref.dtype)
                  * (pc[3:6] - pc[0:3]) + pc[0:3])
        ref = torch.cat([ref[:, :p] + (1 - x).reshape(b, 1, 1) * pseudo,
                         ref[:, p:]], dim=1)
        eye = torch.eye(4, dtype=ego.dtype, device=ego.device)
        ego = torch.cat([ego[:, :p] + (1 - x).reshape(b, 1, 1, 1) * eye,
                         ego[:, p:]], dim=1)
    return MemoryBank(emb, ref, ts, ego, velo)


def propagated_queries(cfg: StreamPETRHeadConfig, cls_last):
    """(B, Q, classes) last-layer logits -> (B, topk_proposals) indices of
    the queries that enter the bank, best first."""
    rec_score = torch.sigmoid(cls_last).amax(dim=-1)
    # stable: tied scores keep ascending index order, as lax.top_k does
    return torch.sort(rec_score, dim=1, descending=True,
                      stable=True).indices[:, :cfg.topk_proposals]


def post_update_memory(cfg: StreamPETRHeadConfig, bank: MemoryBank,
                       timestamp, ego_pose, all_cls_scores, all_bbox_preds,
                       outs_dec, rec_ego_pose, dn_pad: int = 0) -> MemoryBank:
    """Propagate the top-k current queries into the bank and return it to
    the global frame (streampetr_head.py:227-262); the DN queries (the
    first dn_pad) stay out, and what enters the bank is detached."""
    cls_last = all_cls_scores[-1][:, dn_pad:]
    box_last = all_bbox_preds[-1][:, dn_pad:].detach()
    out_last = outs_dec[-1][:, dn_pad:].detach()
    topk_idx = propagated_queries(cfg, cls_last.detach())
    rec_ts = topk_gather(torch.zeros_like(cls_last[..., :1]), topk_idx)
    rec_ref = topk_gather(box_last[..., :3], topk_idx)
    rec_mem = topk_gather(out_last, topk_idx)
    rec_ego = topk_gather(rec_ego_pose[:, :cls_last.shape[1]], topk_idx)
    rec_velo = topk_gather(box_last[..., -2:], topk_idx)
    L = cfg.memory_len
    emb = torch.cat([rec_mem, bank.embedding], dim=1)[:, :L]
    ts = torch.cat([rec_ts, bank.timestamp], dim=1)[:, :L]
    ego = torch.cat([rec_ego, bank.egopose], dim=1)[:, :L]
    ref = torch.cat([rec_ref, bank.reference_point], dim=1)[:, :L]
    velo = torch.cat([rec_velo, bank.velo], dim=1)[:, :L]
    ref = transform_reference_points(ref, ego_pose)
    ts = ts - timestamp[:, None, None]
    ego = torch.einsum("bij,bljk->blik", ego_pose, ego)
    return MemoryBank(emb, ref, ts, ego, velo)


def location_grid(h: int, w: int, stride: int, pad_h: int, pad_w: int,
                  device="cuda"):
    """Pixel-center grid normalized by the padded image size, (h, w, 2),
    built once per shape and device."""
    def build():
        sx = (np.arange(w, dtype=np.float32) * stride + stride // 2) / pad_w
        sy = (np.arange(h, dtype=np.float32) * stride + stride // 2) / pad_h
        gx, gy = np.meshgrid(sx, sy)
        return torch.from_numpy(np.stack([gx, gy], axis=-1))
    return device_const(("location_grid", h, w, stride, pad_h, pad_w),
                        device, build)


def position_embeding(head: StreamPETRHead, cfg: StreamPETRHeadConfig, data,
                      centers, embed_dtype=None, topk_indexes=None):
    """3D position embedding from LID-binned frustum rays
    (streampetr_head.py:278-335), at the tokens ``topk_indexes`` (B, K, 1)
    picks when given (training's focal order), else at all N*h*w. Returns
    (pos_embed (B, K, C), cone (B, K, 8))."""
    eps = 1e-5
    b, n = data["intrinsics"].shape[:2]
    h, w = centers.shape[:2]
    hw = h * w
    pad_h, pad_w = data["pad_shape"]
    dev = centers.device
    intrinsic = torch.stack([data["intrinsics"][..., 0, 0],
                             data["intrinsics"][..., 1, 1]], dim=-1)
    intrinsic = intrinsic.abs() / 1e3
    intrinsic = intrinsic[:, None].expand(b, hw, n, 2).reshape(b, hw * n, 2)
    intrinsic = topk_gather(intrinsic, topk_indexes)
    centers_px = centers * const_vector((pad_w, pad_h), centers.dtype, dev)
    centers_px = centers_px.reshape(1, 1, hw, 2).expand(b, n, hw, 2)
    centers_px = topk_gather(centers_px.reshape(b, n * hw, 1, 2),
                             topk_indexes)
    k = centers_px.shape[1]
    coords_d = device_const(
        ("lid_depth_bins", cfg.depth_num, cfg.LID, cfg.depth_start,
         cfg.position_range[3]), dev,
        lambda: torch.from_numpy(lid_depth_bins(cfg)))
    d = cfg.depth_num
    xy = centers_px.expand(b, k, d, 2)
    dd = coords_d.reshape(1, 1, d, 1).expand(b, k, d, 1)
    coords = torch.cat([xy * dd.clamp(min=eps), dd, torch.ones_like(dd)],
                       dim=-1)
    img2lidar = data["img2lidar"][:, :, None].expand(b, n, hw, 4, 4)
    img2lidar = topk_gather(img2lidar.reshape(b, n * hw, 4, 4), topk_indexes)
    coords3d = torch.einsum("bkij,bkdj->bkdi", img2lidar, coords)[..., :3]
    pr = const_vector(cfg.position_range, coords3d.dtype, dev)
    coords3d = (coords3d - pr[0:3]) / (pr[3:6] - pr[0:3])
    coords3d = coords3d.reshape(b, k, d * 3)
    pos_in = inverse_sigmoid(coords3d)
    if embed_dtype is not None:
        pos_in = pos_in.to(embed_dtype)
    pos_embed = mlp_relu(head.position_encoder, pos_in)
    cone = torch.cat([intrinsic, coords3d[..., -3:], coords3d[..., -90:-87]],
                     dim=-1)
    return pos_embed, cone


def temporal_alignment(head: StreamPETRHead, cfg: StreamPETRHeadConfig,
                       bank: MemoryBank, query_pos, tgt, reference_points):
    """Condition queries and memory on ego motion and splice the first
    num_propagated memory slots into the live queries
    (streampetr_head.py:342-396)."""
    b = query_pos.shape[0]
    dev = query_pos.device
    pc = const_vector(cfg.pc_range, torch.float32, dev)
    temp_ref_norm = (bank.reference_point - pc[:3]) / (pc[3:6] - pc[:3])
    temp_pos = mlp_relu(head.query_embedding,
                        pos2posemb3d(temp_ref_norm,
                                     num_pos_feats=cfg.embed_dims // 2))
    temp_memory = bank.embedding
    if cfg.with_ego_pos:
        eye_flat = torch.eye(4, dtype=torch.float32, device=dev)[:3, :]
        eye_flat = eye_flat.reshape(1, 1, 12).expand(b, query_pos.shape[1], 12)
        rec_motion = torch.cat(
            [torch.zeros_like(reference_points[..., :3]), eye_flat], dim=-1)
        rec_motion = nerf_positional_encoding(rec_motion)
        tgt = mln(head.ego_pose_memory, tgt, rec_motion)
        query_pos = mln(head.ego_pose_pe, query_pos, rec_motion)
        mem_motion = torch.cat(
            [bank.velo, bank.timestamp,
             bank.egopose[..., :3, :].reshape(b, -1, 12)], dim=-1)
        mem_motion = nerf_positional_encoding(mem_motion.float())
        temp_pos = mln(head.ego_pose_pe, temp_pos, mem_motion)
        temp_memory = mln(head.ego_pose_memory, temp_memory, mem_motion)
    te = head.time_embedding
    query_pos = query_pos + ln(te[1], lin(te[0], pos2posemb1d(
        torch.zeros_like(reference_points[..., :1]),
        num_pos_feats=cfg.embed_dims)), LN_EPS)
    temp_pos = temp_pos + ln(te[1], lin(te[0], pos2posemb1d(
        bank.timestamp, num_pos_feats=cfg.embed_dims)), LN_EPS)
    if cfg.num_propagated > 0:
        p = cfg.num_propagated
        tgt = torch.cat([tgt, temp_memory[:, :p]], dim=1)
        query_pos = torch.cat([query_pos, temp_pos[:, :p]], dim=1)
        reference_points = torch.cat([reference_points, temp_ref_norm[:, :p]],
                                     dim=1)
        temp_memory = temp_memory[:, p:]
        temp_pos = temp_pos[:, p:]
    rec_ego_pose = torch.eye(4, dtype=query_pos.dtype, device=dev).expand(
        b, query_pos.shape[1], 4, 4)
    return tgt, query_pos, reference_points, temp_memory, temp_pos, \
        rec_ego_pose


def head_queries(head: StreamPETRHead, cfg: StreamPETRHeadConfig, feats,
                 data, topk_indexes=None, dn=None):
    """The decoder's inputs before the temporal steps (streampetr_head.py:
    403-455): the memory tokens and their position embedding (bf16 with
    compute_dtype 'bfloat16', else f32), the queries' reference points (the
    DN queries' first when ``dn`` is given), their position embedding and
    zero content (f32). Returns (memory, pos_embed, tgt, query_pos,
    reference_points, attn_mask, pad_size)."""
    b, n, h, w, c = feats.shape
    memory = topk_gather(feats.reshape(b, n * h * w, c), topk_indexes)
    if cfg.compute_dtype == "bfloat16":
        memory = memory.to(torch.bfloat16)
    centers = location_grid(h, w, cfg.stride, *data["pad_shape"],
                            device=feats.device)
    pos_embed, cone = position_embeding(head, cfg, data, centers,
                                        embed_dtype=memory.dtype,
                                        topk_indexes=topk_indexes)
    memory = mlp_relu(head.memory_embed, memory)
    memory = mln(head.spatial_alignment, memory, cone.to(memory.dtype))
    pos_embed = se_linear(head.featurized_pe, pos_embed.to(memory.dtype),
                          memory)
    if dn is not None:
        reference_points = dn["padded_reference_points"]
        attn_mask, pad_size = dn["attn_mask"], dn["pad_size"]
    else:
        reference_points = head.reference_points.weight[None].expand(
            b, cfg.num_query, 3)
        attn_mask, pad_size = None, 0
    query_pos = mlp_relu(head.query_embedding,
                         pos2posemb3d(reference_points,
                                      num_pos_feats=cfg.embed_dims // 2))
    tgt = torch.zeros_like(query_pos)
    return memory, pos_embed, tgt, query_pos, reference_points, attn_mask, \
        pad_size


def head_outputs(head: StreamPETRHead, cfg: StreamPETRHeadConfig, outs_dec,
                 reference_points):
    """Every decoder layer's scores and boxes (streampetr_head.py:476-495):
    the shared branches over outs_dec (L, B, Q, C) f32, the centres offset
    from the reference points and denormalised to pc_range. Returns
    (all_cls_scores, all_bbox_preds)."""
    ref_inv = inverse_sigmoid(reference_points.clamp(0.0, 1.0))
    all_cls, all_box = [], []
    for lvl in range(outs_dec.shape[0]):
        cls = cls_branch_forward(head.cls_branches[0], outs_dec[lvl])
        tmp = reg_branch_forward(head.reg_branches[0], outs_dec[lvl])
        xyz = torch.sigmoid(tmp[..., 0:3] + ref_inv)
        all_cls.append(cls)
        all_box.append(torch.cat([xyz, tmp[..., 3:]], dim=-1))
    all_cls_scores = torch.stack(all_cls)
    all_bbox_preds = torch.stack(all_box)
    pc = const_vector(cfg.pc_range, all_bbox_preds.dtype, outs_dec.device)
    xyz = all_bbox_preds[..., 0:3] * (pc[3:6] - pc[0:3]) + pc[0:3]
    return all_cls_scores, torch.cat([xyz, all_bbox_preds[..., 3:]], dim=-1)


def split_dn(all_cls_scores, all_bbox_preds, pad_size: int) -> dict:
    """The head's outs: the matching queries' scores and boxes and, with
    pad_size DN queries in front, theirs as dn_cls_scores /
    dn_bbox_preds."""
    if pad_size > 0:
        return {"all_cls_scores": all_cls_scores[:, :, pad_size:],
                "all_bbox_preds": all_bbox_preds[:, :, pad_size:],
                "dn_cls_scores": all_cls_scores[:, :, :pad_size],
                "dn_bbox_preds": all_bbox_preds[:, :, :pad_size]}
    return {"all_cls_scores": all_cls_scores,
            "all_bbox_preds": all_bbox_preds}


def head_forward(head: StreamPETRHead, cfg: StreamPETRHeadConfig, feats,
                 data, bank: MemoryBank, topk_indexes=None, dn=None,
                 drop_masks=None, remat: bool = False):
    """One frame (streampetr_head.py:403-502). feats (B, N, h, w, C) f32
    neck features; data: intrinsics, img2lidar, timestamp, ego_pose,
    ego_pose_inv, prev_exists and 'pad_shape'. Returns (outs, new
    MemoryBank).

    Training passes the memory tokens' FocalHead order ``topk_indexes``
    (B, K, 1); ``dn`` (core/dn.prepare_for_dn, with
    'padded_reference_points') puts the DN queries first under their
    attention mask; the decoder takes the dropout masks ``drop_masks``
    and, with ``remat``, checkpoints each layer. outs holds every layer's
    scores and boxes of the matching queries and, with dn, of the DN
    queries (dn_cls_scores, dn_bbox_preds)."""
    bank = pre_update_memory(cfg, head, bank, data["timestamp"],
                             data["ego_pose_inv"], data["prev_exists"])
    (memory, pos_embed, tgt, query_pos, reference_points, attn_mask,
     pad_size) = head_queries(head, cfg, feats, data, topk_indexes, dn)
    (tgt, query_pos, reference_points, temp_memory, temp_pos,
     rec_ego_pose) = temporal_alignment(head, cfg, bank, query_pos, tgt,
                                        reference_points)
    if cfg.compute_dtype == "bfloat16":
        tgt, memory, query_pos, pos_embed, temp_memory, temp_pos = (
            t.to(torch.bfloat16) for t in (tgt, memory, query_pos, pos_embed,
                                           temp_memory, temp_pos))
    with stage("decoder"):
        outs_dec = decoder_forward(head.transformer.decoder, cfg.decoder,
                                   tgt, memory, query_pos, pos_embed,
                                   temp_memory, temp_pos, attn_mask=attn_mask,
                                   drop_masks=drop_masks, remat=remat)
    outs_dec = torch.nan_to_num(outs_dec.float())
    all_cls_scores, all_bbox_preds = head_outputs(head, cfg, outs_dec,
                                                  reference_points)
    bank = post_update_memory(cfg, bank, data["timestamp"], data["ego_pose"],
                              all_cls_scores, all_bbox_preds, outs_dec,
                              rec_ego_pose, pad_size)
    return split_dn(all_cls_scores, all_bbox_preds, pad_size), bank
