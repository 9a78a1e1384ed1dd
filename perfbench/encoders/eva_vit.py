"""The EVA-02 ViT image encoder (ViTDet-style windowed blocks, 2D RoPE,
SwiGLU with a sub-LayerNorm), with ToC3D's motion-query-guided token
selectors and compressed blocks where the configuration sets pruning
locations, and the first level of the CPFPN neck: its weight layout, its
plain float32 reference, its operation count and its int8 switch (the
interface is perfbench/encoders/__init__.py).

Reference semantics, each as the reference code has it:
* a full block normalises with norm1, then zero-pads to whole windows
  (ViTDet / EVA-02 ``Block``), attends within each window with the 2D RoPE
  of its grid, and runs the SwiGLU MLP with its sub-LayerNorm;
* from the first pruning location on, a selector scores the tokens (the
  first-frame score MLP blended in by prev_exists), its soft mask is handed
  to the next selector, and each block keeps per window the best
  int(n * ratio) tokens (pads score -1e6), one fewer where k + 1 = 1 mod 128
  when the configuration sets mxu_align_k, adds the score-weighted mean of
  the dropped tokens as a representative row, runs attention with the RoPE
  rows of the kept tokens and the MLP on those rows, adds the
  representative's two deltas to every dropped token and scatters back;
* the neck's first level: a 1x1, then a 3x3 convolution.

Counting (``flops``; the rules of perfbench/counting.py). Token grid: a
view of H x W pixels has (H / p) x (W / p) tokens at patch size p. A
window block partitions the grid into ws x ws windows, the last ones
padded. A full block needs its projections and MLP on the real tokens
only, and attention of each real token over its whole window (the pads are
keys: the reference zero-pads after norm1). A compressed block keeps, per
window, k = int(ws^2 * ratio) tokens (one fewer where k + 1 = 1 mod 128 when
the configuration sets mxu_align_k) plus one representative row. That count
includes a window's pads, which is the reference's semantics: pads score
-1e6 but are kept where a window holds fewer than k real tokens, so the
compressed rows are windows x (k + 1) of every window, padded or not.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from ..counting import mm
from ..reference.model import (LN_EPS, _lin, _ln, _mln, nerf_pe,
                               pos2posemb1d, pos2posemb3d, transform_points)
from ..weights import Layout

IMG_NORM_MEAN = (103.530, 116.280, 123.675)
IMG_NORM_STD = (57.375, 57.120, 58.395)
VIT_LN_EPS = 1e-6


# ---------------------------------------------------------------------------
# weight layout
# ---------------------------------------------------------------------------

def layout(cfg):
    """Patch embedding, position table, blocks (their norm1, norm2 and
    sub-LN carry outlier channels), selectors, the neck's first level."""
    bc, nc = cfg["backbone"], cfg["neck"]
    out = Layout()
    lin, norm, conv, mln = out.lin, out.norm, out.conv, out.mln
    d, p = bc["embed_dim"], bc["patch_size"]
    hid = int(d * bc["mlp_ratio"])
    conv("img_backbone.patch_embed.proj", 3, d, p)
    npos = (bc["pretrain_img_size"] // p) ** 2 + int(
        bc["pretrain_use_cls_token"])
    out.append(("img_backbone.pos_embed", (1, npos, d), "b"))
    for i in range(bc["depth"]):
        pre = f"img_backbone.blocks.{i}."
        norm(pre + "norm1", d, outliers=True)
        norm(pre + "norm2", d, outliers=True)
        for n in ("q_proj", "k_proj", "v_proj"):
            lin(pre + "attn." + n, d, d, bias=False)
        out.append((pre + "attn.q_bias", (d,), "b"))
        out.append((pre + "attn.v_bias", (d,), "b"))
        lin(pre + "attn.proj", d, d)
        lin(pre + "mlp.w1", d, hid)
        lin(pre + "mlp.w2", d, hid)
        lin(pre + "mlp.w3", hid, d)
        norm(pre + "mlp.ffn_ln", hid, outliers=True)
    qd = bc.get("query_dim", 0)
    for i in range(len(bc.get("pruning_loc", ()))):
        pre = f"img_backbone.score_predictor.{i}."
        norm(pre + "in_conv.0", d)
        lin(pre + "in_conv.1", d, d)
        lin(pre + "out_conv.0", d, d // 2)
        lin(pre + "out_conv.2", d // 2, d // 4)
        lin(pre + "out_conv.4", d // 4, 2)
        lin(pre + "input_proj.0", d, qd)
        lin(pre + "aggregate.0", bc["pruning_num_queries"], 2)
        lin(pre + "query_embedding.0", qd * 3 // 2, qd)
        lin(pre + "query_embedding.2", qd, qd)
        mln(pre + "ego_pose_pe", 180, qd)
        mln(pre + "ego_pose_queries", 180, qd)
        lin(pre + "time_embedding.0", qd, qd)
        norm(pre + "time_embedding.1", qd)
    oc = nc["out_channels"]
    conv("img_neck.lateral_convs.0.conv", nc["in_channels"][0], oc, 1)
    conv("img_neck.fpn_convs.0.conv", oc, oc, 3)
    return out


# ---------------------------------------------------------------------------
# plain reference
# ---------------------------------------------------------------------------

def rope_table(half: int, pt_seq: int, ft_seq: int, device):
    """EVA-02 2D RoPE over an ft x ft grid: (ft*ft, 2*half) cos and sin,
    the first half of the lanes from the row index, the second from the
    column index, each frequency on two neighbouring lanes."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, half, 2)[:half // 2]
                               .astype(np.float64) / half))
    t = np.arange(ft_seq, dtype=np.float64) / ft_seq * pt_seq
    f = np.repeat(np.outer(t, freqs), 2, axis=-1)
    grid = np.concatenate([np.broadcast_to(f[:, None], (ft_seq, ft_seq,
                                                        f.shape[-1])),
                           np.broadcast_to(f[None, :], (ft_seq, ft_seq,
                                                        f.shape[-1]))],
                          axis=-1).reshape(ft_seq * ft_seq, -1)
    return (torch.tensor(np.cos(grid), dtype=torch.float32, device=device),
            torch.tensor(np.sin(grid), dtype=torch.float32, device=device))


def _rot(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _windows(x, ws, value=0.0):
    """(B, H, W, C) -> (B * nW, ws * ws, C), zero-padded (or ``value``)."""
    b, h, w, c = x.shape
    ph, pw = -h % ws, -w % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph), value=value)
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c), (hp, wp)


def _unwindows(xw, ws, padded, hw):
    hp, wp = padded
    h, w = hw
    nwh, nww = hp // ws, wp // ws
    b = xw.shape[0] // (nwh * nww)
    x = xw.reshape(b, nwh, nww, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def _attention(sd, pre, x, heads, cos, sin, chunk=64):
    """EVA attention over rows x (W, n, C): q/k/v projections (q and v
    biases), RoPE on q and k (cos/sin (W or 1, n, d)), softmax, proj.
    Windows in chunks, so the f32 logits stay bounded."""
    nw, n, c = x.shape
    d = c // heads
    out = []
    for s in range(0, nw, chunk):
        xs = x[s:s + chunk]
        cs = cos if cos.shape[0] == 1 else cos[s:s + chunk]
        sn = sin if sin.shape[0] == 1 else sin[s:s + chunk]
        q = F.linear(xs, sd[pre + "attn.q_proj.weight"],
                     sd[pre + "attn.q_bias"])
        k = F.linear(xs, sd[pre + "attn.k_proj.weight"])
        v = F.linear(xs, sd[pre + "attn.v_proj.weight"],
                     sd[pre + "attn.v_bias"])
        q, k, v = (t.unflatten(-1, (heads, d)).transpose(1, 2)
                   for t in (q, k, v))
        cs, sn = cs[:, None], sn[:, None]
        q = q * cs + _rot(q) * sn
        k = k * cs + _rot(k) * sn
        p = torch.softmax((q * d ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out.append((p @ v).transpose(1, 2).reshape(xs.shape[0], n, c))
    return _lin(sd, pre + "attn.proj", torch.cat(out))


def _swiglu(sd, pre, x):
    h = F.silu(_lin(sd, pre + "mlp.w1", x)) * _lin(sd, pre + "mlp.w2", x)
    return _lin(sd, pre + "mlp.w3", _ln(sd, pre + "mlp.ffn_ln", h,
                                        VIT_LN_EPS))


def _mlp_rows(sd, pre, x, chunk=8192):
    return torch.cat([_swiglu(sd, pre, _ln(sd, pre + "norm2", r, VIT_LN_EPS))
                      for r in x.split(chunk)])


def full_block(sd, pre, x, heads, ws, table):
    """ViTDet / EVA-02 block: norm1, zero-pad to windows, windowed
    attention, residual; norm2, SwiGLU, residual."""
    b, h, w, c = x.shape
    xw, padded = _windows(_ln(sd, pre + "norm1", x, VIT_LN_EPS), ws)
    cos, sin = (t[None, :ws * ws] for t in table)
    a = _attention(sd, pre, xw, heads, cos, sin)
    x = x + _unwindows(a.reshape(-1, ws, ws, c), ws, padded, (h, w))
    flat = x.reshape(-1, c)
    return (flat + _mlp_rows(sd, pre, flat)).reshape(b, h, w, c)


def keep_count(n, ratio, mxu_align):
    k = int(n * ratio)
    if mxu_align and k > 1 and (k + 1) % 128 == 1:
        k -= 1
    return k


def compressed_block(sd, pre, x, scores, heads, ws, table, ratio, bc):
    """ToC3DEVAViTBlock: per window, the best k tokens and one
    representative of the rest go through attention and the MLP; the rest
    take the representative's two deltas."""
    b, h, w, c = x.shape
    n = ws * ws
    xw, padded = _windows(x, ws)
    sw = _windows(scores.reshape(b, h, w, 1), ws, value=-1e6)[0][..., 0]
    k = keep_count(n, ratio, bc["mxu_align_k"])
    order = torch.sort(sw, dim=-1, descending=True, stable=True)
    slow_idx, fast_idx = order.indices[:, :k], order.indices[:, k:]
    fast_score = order.values[:, k:]
    take = lambda t, i: torch.gather(t, 1, i[..., None].expand(-1, -1, c))
    xs, fast = take(xw, slow_idx), take(xw, fast_idx)
    rep = bc["use_represent_tokens"] and n - k > 0
    pos = slow_idx
    if rep:
        wgt = fast_score / fast_score.sum(dim=1, keepdim=True)
        xs = torch.cat([xs, (wgt[..., None] * fast).sum(1, keepdim=True)], 1)
        pos = torch.cat([pos, torch.full_like(pos[:, :1], k)], dim=1)
    cos, sin = table
    if bc["rope_acc"]:
        cos, sin = cos[pos], sin[pos]
    else:
        cos, sin = cos[None, :pos.shape[1]], sin[None, :pos.shape[1]]
    raw1 = _attention(sd, pre, _ln(sd, pre + "norm1", xs, VIT_LN_EPS), heads,
                      cos, sin)
    s1 = xs + raw1
    raw2 = _mlp_rows(sd, pre, s1.reshape(-1, c)).reshape(s1.shape)
    y = s1 + raw2
    if rep:
        fast = fast + (raw1[:, k:k + 1] + raw2[:, k:k + 1])
    out = torch.zeros_like(xw)
    out.scatter_(1, slow_idx[..., None].expand(-1, -1, c), y[:, :k])
    out.scatter_(1, fast_idx[..., None].expand(-1, -1, c), fast)
    return _unwindows(out.reshape(-1, ws, ws, c), ws, padded, (h, w))


def motion_queries(sd, pre, bc, bank, ego_pose_inv):
    """The selector's motion-aware queries from the first
    pruning_num_queries bank slots."""
    nq, qd = bc["pruning_num_queries"], bc["query_dim"]
    pc = torch.tensor(bc["pc_range"], dtype=torch.float32,
                      device=ego_pose_inv.device)
    ref = transform_points(bank["reference_point"][:, :nq], ego_pose_inv)
    ref = (ref - pc[:3]) / (pc[3:] - pc[:3])
    pos = _lin(sd, pre + "query_embedding.2", F.relu(_lin(
        sd, pre + "query_embedding.0", pos2posemb3d(ref, qd // 2))))
    ego = bank["egopose"][:, :nq]
    motion = nerf_pe(torch.cat([bank["velo"][:, :nq],
                                bank["timestamp"][:, :nq],
                                ego[..., :3, :].flatten(-2)], dim=-1))
    pos = _mlp_ln_pos(sd, pre, pos, motion, bank["timestamp"][:, :nq], qd)
    return _mln(sd, pre + "ego_pose_queries", bank["embedding"][:, :nq],
                motion) + pos


def _mlp_ln_pos(sd, pre, pos, motion, ts, dim):
    pos = _mln(sd, pre + "ego_pose_pe", pos, motion)
    te = _lin(sd, pre + "time_embedding.0", pos2posemb1d(ts, dim))
    return pos + _ln(sd, pre + "time_embedding.1", te, LN_EPS)


def selector(sd, pre, bc, x, mask, bank, ego_pose_inv, prev_exists):
    """MotionAwareQueryGuidedTokenSelector: (BN, H, W, C) tokens ->
    (scores (BN, H*W), log-softmax pair (BN, H*W, 2))."""
    bn, h, w, c = x.shape
    b = prev_exists.shape[0]
    t = x.reshape(bn, h * w, c)
    if bc["score_mask"] and mask is not None:
        t = t * mask.reshape(bn, h * w, 1)
    q = motion_queries(sd, pre, bc, bank, ego_pose_inv)
    q = q.repeat_interleave(bn // b, dim=0)
    proj = _lin(sd, pre + "input_proj.0", t)
    scale = bc["query_dim"] ** -0.5 if bc["pruning_attn_scale"] else 1.0
    attn = torch.einsum("bnc,bqc->bnq", proj, q) * scale
    pred = F.log_softmax(_lin(sd, pre + "aggregate.0", attn), dim=-1)
    pe = prev_exists.reshape(b, 1, 1, 1).expand(b, bn // b, 1, 1)
    pe = pe.reshape(bn, 1, 1)
    if bool((prev_exists <= 0).any()):
        hh = F.gelu(_lin(sd, pre + "in_conv.1",
                         _ln(sd, pre + "in_conv.0", t, LN_EPS)))
        half = hh.shape[-1] // 2
        glob = hh[..., half:].mean(dim=1, keepdim=True)
        hh = torch.cat([hh[..., :half], glob.expand_as(hh[..., :half])], -1)
        hh = F.gelu(_lin(sd, pre + "out_conv.0", hh))
        hh = F.gelu(_lin(sd, pre + "out_conv.2", hh))
        mlp = F.log_softmax(_lin(sd, pre + "out_conv.4", hh), dim=-1)
        pred = mlp * (1.0 - pe) + pred * pe
    return pred[..., 0], pred


def abs_pos(sd, bc, h, w):
    pe = sd["img_backbone.pos_embed"]
    if bc["pretrain_use_cls_token"]:
        pe = pe[:, 1:]
    size = int(round(math.sqrt(pe.shape[1])))
    grid = pe.reshape(1, size, size, -1).permute(0, 3, 1, 2)
    if (size, size) != (h, w):
        grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                             align_corners=False)
    return grid.permute(0, 2, 3, 1)


def backbone(sd, cfg, img, bank, frame):
    """(B, N, H, W, 3) uint8 BGR images -> (B*N, h, w, C) features."""
    bc = cfg["backbone"]
    b, n, hh, ww, _ = img.shape
    mean = torch.tensor(IMG_NORM_MEAN, device=img.device)
    std = torch.tensor(IMG_NORM_STD, device=img.device)
    x = ((img.float() - mean) / std).reshape(b * n, hh, ww, 3)
    p = bc["patch_size"]
    x = F.conv2d(x.permute(0, 3, 1, 2),
                 sd["img_backbone.patch_embed.proj.weight"],
                 sd["img_backbone.patch_embed.proj.bias"], stride=p)
    x = x.permute(0, 2, 3, 1)
    bn, h, w, c = x.shape
    if bc["use_abs_pos"]:
        x = x + abs_pos(sd, bc, h, w)
    half = bc["embed_dim"] // bc["num_heads"] // 2
    ft_win = bc["window_size"] if bc["intp_freq"] else bc["pt_hw_seq_len"]
    ft_glb = (bc["img_size"] // p) if bc["intp_freq"] else \
        bc["pt_hw_seq_len"]
    tables = {False: rope_table(half, bc["pt_hw_seq_len"], ft_win, x.device),
              True: rope_table(half, bc["pt_hw_seq_len"], ft_glb, x.device)}
    prune = list(bc.get("pruning_loc", ()))
    mask = torch.ones(bn, h * w, 1, device=x.device)
    scores, ratio, seg = None, None, 0
    for i in range(bc["depth"]):
        pre = f"img_backbone.blocks.{i}."
        if i in prune:
            scores, pred = selector(
                sd, f"img_backbone.score_predictor.{seg}.", bc, x, mask,
                bank, frame["ego_pose_inv"], frame["prev_exists"])
            mask = torch.softmax(pred, dim=-1)[..., 0:1]
            ratio = bc["token_ratio"][seg]
            seg += 1
        glob = i in bc["global_attn_indexes"]
        ws = bc["global_window_size"] if glob else bc["window_size"]
        accelerated = bool(prune) and i >= prune[0] and (
            not glob or bc["accelerate_global"])
        if accelerated:
            x = compressed_block(sd, pre, x, scores, bc["num_heads"], ws,
                                 tables[glob], ratio, bc)
        else:
            x = full_block(sd, pre, x, bc["num_heads"], ws, tables[glob])
    return x


def neck(sd, x):
    """CPFPN's first level: 1x1 then 3x3 convolution."""
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 sd["img_neck.lateral_convs.0.conv.weight"],
                 sd["img_neck.lateral_convs.0.conv.bias"])
    y = F.conv2d(y, sd["img_neck.fpn_convs.0.conv.weight"],
                 sd["img_neck.fpn_convs.0.conv.bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def features(sd, cfg, img, bank, frame):
    """(B, N, H, W, 3) uint8 BGR images -> (B*N, h, w, C): the backbone,
    then the neck's first level."""
    return neck(sd, backbone(sd, cfg, img, bank, frame))


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def grid(cfg: dict, views: int, batch: int):
    """(maps, h, w): token maps of one frame and their size."""
    p = cfg["backbone"]["patch_size"]
    hh, ww = cfg["pad_shape"]
    return batch * views, hh // p, ww // p


def blocks(cfg: dict, views: int, batch: int):
    """One dict a block: ws, windows, and either kind 'full' (tokens: real
    tokens) or 'compressed' (rows: windows x (k + representative))."""
    bc = cfg["backbone"]
    maps, h, w = grid(cfg, views, batch)
    prune = list(bc.get("pruning_loc", ()))
    out, ratio, seg = [], None, 0
    for i in range(bc["depth"]):
        if i in prune:
            ratio = bc["token_ratio"][seg]
            seg += 1
        glob = i in bc["global_attn_indexes"]
        ws = bc["global_window_size"] if glob else bc["window_size"]
        windows = maps * math.ceil(h / ws) * math.ceil(w / ws)
        accelerated = bool(prune) and i >= prune[0] and (
            not glob or bc["accelerate_global"])
        if accelerated:
            n = ws * ws
            k = keep_count(n, ratio, bc["mxu_align_k"])
            rep = int(bc["use_represent_tokens"] and n - k > 0)
            out.append({"kind": "compressed", "ws": ws, "windows": windows,
                        "per_window": k + rep, "rows": windows * (k + rep)})
        else:
            out.append({"kind": "full", "ws": ws, "windows": windows,
                        "rows": maps * h * w})
    return out


def block_gemms(cfg: dict, rows: int):
    """[(label, M, N, K)] of one block's weight products on ``rows`` rows:
    q, k, v together, the output projection, the SwiGLU's two gates
    together, and w3."""
    c = cfg["backbone"]["embed_dim"]
    hid = int(c * cfg["backbone"]["mlp_ratio"])
    return [("qkv", rows, 3 * c, c), ("o", rows, c, c),
            ("gate", rows, 2 * hid, c), ("w3", rows, c, hid)]


def flops(cfg: dict, views: int, batch: int) -> float:
    """Operations of one steady frame (prev_exists 1): the patch
    embedding, the blocks, the selectors and the neck."""
    bc = cfg["backbone"]
    maps, h, w = grid(cfg, views, batch)
    tokens = maps * h * w
    c = bc["embed_dim"]
    p = bc["patch_size"]
    total = mm(tokens, c, 3 * p * p)
    for blk in blocks(cfg, views, batch):
        rows = blk["rows"]
        total += sum(mm(*g[1:]) for g in block_gemms(cfg, rows))
        if blk["kind"] == "full":
            # each real token's query over its window's ws^2 keys
            total += 2 * mm(tokens, blk["ws"] ** 2, c)
        else:
            total += 2 * mm(rows, blk["per_window"], c)
    qd, nq = bc.get("query_dim", 0), bc.get("pruning_num_queries", 0)
    for _ in bc.get("pruning_loc", ()):
        # input projection, token-query attention, aggregate
        total += mm(tokens, qd, c) + mm(tokens, nq, qd) + mm(tokens, 2, nq)
    oc = cfg["neck"]["out_channels"]
    total += mm(tokens, oc, c) + mm(tokens, oc, oc * 9)
    return total


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------

def control(program_cfg):
    """The program's backbone on its int8 path (dynamic scales)."""
    return replace(program_cfg, backbone=replace(program_cfg.backbone,
                                                 quant="int8"))
