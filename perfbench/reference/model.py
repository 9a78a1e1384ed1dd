"""Plain float32 reference of one streaming frame of ToC3D / StreamPETR
(the published mmdet3d models: EVA-02 ViT-L with motion-query-guided token
compression, CPFPN, the StreamPETR head with its memory bank, the NMS-free
decode).

Written from the published description and the reference code's equations,
in plain PyTorch, float32 only; it imports nothing of the measured program
and takes only a state dict of reference (mmdet3d) names, the configuration
file's sizes, a frame and the memory bank going into it. Call
``set_plain_math()`` first on a GPU: TF32 off, so every float32 product is
float32.

Semantics, each as the reference code has it:
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
* the head aligns the bank to the current ego frame, resets it where
  prev_exists is 0, splices the first num_propagated slots into the
  queries, runs the post-norm decoder (self-attention over queries and
  memory, cross-attention over every image token) and pushes the best
  topk_proposals queries into the bank.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMG_NORM_MEAN = (103.530, 116.280, 123.675)
IMG_NORM_STD = (57.375, 57.120, 58.395)
VIT_LN_EPS = 1e-6
LN_EPS = 1e-5
BANK_KEYS = ("embedding", "reference_point", "timestamp", "egopose", "velo")


def set_plain_math():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def _lin(sd, name, x):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _ln(sd, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def _ln_plain(x, eps):
    return F.layer_norm(x, x.shape[-1:], None, None, eps)


def _mln(sd, name, x, c):
    """Meta LayerNorm: LayerNorm without affine, scaled and shifted by
    linears of relu(reduce(c))."""
    c = F.relu(_lin(sd, name + ".reduce.0", c))
    return _lin(sd, name + ".gamma", c) * _ln_plain(x, 1e-5) + \
        _lin(sd, name + ".beta", c)


def _mlp_relu(sd, name, x, n):
    for i in range(n):
        x = _lin(sd, f"{name}.{2 * i}", x)
        if i < n - 1:
            x = F.relu(x)
    return x


def _sine(x, feats, temperature=10000.0):
    dim_t = torch.arange(feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / feats)
    pos = x[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def pos2posemb3d(pos, feats):
    pos = pos * (2 * math.pi)
    return torch.cat([_sine(pos[..., 1], feats), _sine(pos[..., 0], feats),
                      _sine(pos[..., 2], feats)], dim=-1)


def pos2posemb1d(pos, feats):
    return _sine(pos[..., 0] * (2 * math.pi), feats)


def nerf_pe(x, n=6):
    freqs = 2.0 ** torch.linspace(0.0, n - 1, n, device=x.device)
    out = []
    for i in range(n):
        out += [torch.sin(x * freqs[i]), torch.cos(x * freqs[i])]
    return torch.cat(out, dim=-1)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def transform_points(pts, pose):
    """(B, N, 3) points through (B, 4, 4) poses."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return torch.einsum("bij,bnj->bni", pose, p)[..., :3]


def stable_topk(x, k):
    """Indices of the k largest along the last axis, best first; equal
    values keep ascending index order."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


# ---------------------------------------------------------------------------
# backbone
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


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

H = "pts_bbox_head."


def _refresh(t, x):
    return t * x.reshape([t.shape[0]] + [1] * (t.dim() - 1))


def pre_update_memory(sd, hc, bank, frame):
    x = frame["prev_exists"]
    b = x.shape[0]
    inv = frame["ego_pose_inv"]
    ts = _refresh(bank["timestamp"] + frame["timestamp"][:, None, None], x)
    ego = _refresh(torch.einsum("bij,bljk->blik", inv, bank["egopose"]), x)
    ref = _refresh(transform_points(bank["reference_point"], inv), x)
    emb = _refresh(bank["embedding"], x)
    velo = _refresh(bank["velo"], x)
    p = hc["num_propagated"]
    if p > 0:
        pc = torch.tensor(hc["pc_range"], device=ref.device)
        pseudo = (sd[H + "pseudo_reference_points.weight"] * (pc[3:] - pc[:3])
                  + pc[:3])
        ref = torch.cat([ref[:, :p] + (1 - x).reshape(b, 1, 1) * pseudo,
                         ref[:, p:]], 1)
        eye = torch.eye(4, device=ref.device)
        ego = torch.cat([ego[:, :p] + (1 - x).reshape(b, 1, 1, 1) * eye,
                         ego[:, p:]], 1)
    return {"embedding": emb, "reference_point": ref, "timestamp": ts,
            "egopose": ego, "velo": velo}


def lid_bins(hc):
    i = np.arange(hc["depth_num"], dtype=np.float64)
    r = hc["position_range"][3]
    if hc["LID"]:
        bin_size = (r - hc["depth_start"]) / (hc["depth_num"] *
                                              (1 + hc["depth_num"]))
        return hc["depth_start"] + bin_size * i * (i + 1)
    return hc["depth_start"] + (r - hc["depth_start"]) / hc["depth_num"] * i


def position_embedding(sd, hc, frame, n, h, w, pad_shape):
    """StreamPETR's 3D position embedding of every image token (view-major,
    then row, then column) and the spatial-alignment cone."""
    dev = frame["intrinsics"].device
    b = frame["intrinsics"].shape[0]
    pad_h, pad_w = pad_shape
    s = hc["stride"]
    xs = (np.arange(w, dtype=np.float32) * s + s // 2) / pad_w * pad_w
    ys = (np.arange(h, dtype=np.float32) * s + s // 2) / pad_h * pad_h
    gx, gy = np.meshgrid(xs, ys)
    px = torch.tensor(np.stack([gx, gy], -1).reshape(h * w, 2), device=dev)
    d = hc["depth_num"]
    dd = torch.tensor(lid_bins(hc), dtype=torch.float32, device=dev)
    dd = dd.reshape(1, d, 1).expand(h * w, d, 1)
    coords = torch.cat([px[:, None].expand(h * w, d, 2) *
                        dd.clamp(min=1e-5), dd, torch.ones_like(dd)], -1)
    c3 = torch.einsum("bnij,kdj->bnkdi", frame["img2lidar"], coords)[..., :3]
    pr = torch.tensor(hc["position_range"], device=dev)
    c3 = ((c3 - pr[:3]) / (pr[3:] - pr[:3])).reshape(b, n * h * w, d * 3)
    pos = _mlp_relu(sd, H + "position_encoder", inverse_sigmoid(c3), 2)
    intr = torch.stack([frame["intrinsics"][..., 0, 0],
                        frame["intrinsics"][..., 1, 1]], -1).abs() / 1e3
    # the reference tiles the intrinsics with .repeat(1, H*W, 1): token j
    # of the view-major sequence takes view j % N
    intr = intr[:, None].expand(b, h * w, n, 2).reshape(b, n * h * w, 2)
    cone = torch.cat([intr, c3[..., -3:], c3[..., -90:-87]], -1)
    return pos, cone


def decoder_layer(sd, pre, heads, q, mem, qpos, mpos, tmem, tpos):
    tk, tp = torch.cat([q, tmem], 1), torch.cat([qpos, tpos], 1)
    q = _ln(sd, pre + "norms.0", q + _mha(sd, pre + "attentions.0.attn",
                                          q + qpos, tk + tp, tk, heads),
            LN_EPS)
    q = _ln(sd, pre + "norms.1", q + _mha(sd, pre + "attentions.1.attn",
                                          q + qpos, mem + mpos, mem, heads),
            LN_EPS)
    f = _lin(sd, pre + "ffns.0.layers.1",
             F.relu(_lin(sd, pre + "ffns.0.layers.0.0", q)))
    return _ln(sd, pre + "norms.2", q + f, LN_EPS)


def _mha(sd, pre, query, key, value, heads):
    c = query.shape[-1]
    w, bias = sd[pre + ".in_proj_weight"], sd[pre + ".in_proj_bias"]
    q = F.linear(query, w[:c], bias[:c])
    k = F.linear(key, w[c:2 * c], bias[c:2 * c])
    v = F.linear(value, w[2 * c:], bias[2 * c:])
    b, nq, _ = q.shape
    d = c // heads
    q, k, v = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))
    out = []
    for hh in range(heads):     # one head at a time bounds the f32 logits
        p = torch.softmax((q[:, hh] * d ** -0.5) @ k[:, hh].transpose(-1, -2),
                          dim=-1)
        out.append(p @ v[:, hh])
    o = torch.stack(out, 1).transpose(1, 2).reshape(b, nq, c)
    return F.linear(o, sd[pre + ".out_proj.weight"],
                    sd[pre + ".out_proj.bias"])


def _cls_branch(sd, x):
    p = H + "cls_branches.0."
    x = F.relu(_ln(sd, p + "1", _lin(sd, p + "0", x), LN_EPS))
    x = F.relu(_ln(sd, p + "4", _lin(sd, p + "3", x), LN_EPS))
    return _lin(sd, p + "6", x)


def _reg_branch(sd, x):
    p = H + "reg_branches.0."
    x = F.relu(_lin(sd, p + "0", x))
    x = F.relu(_lin(sd, p + "2", x))
    return _lin(sd, p + "4", x)


def head(sd, cfg, feats, frame, bank):
    """feats (B, N, h, w, C) -> (last layer's logits (B, Q, classes), boxes
    (B, Q, 10) with metric centres, the queries' decoder outputs (B, Q, C),
    the new bank)."""
    hc = cfg["head"]
    b, n, h, w, c = feats.shape
    e = hc["embed_dims"]
    dev = feats.device
    bank = pre_update_memory(sd, hc, bank, frame)
    mem = feats.reshape(b, n * h * w, c)
    pos, cone = position_embedding(sd, hc, frame, n, h, w, cfg["pad_shape"])
    mem = _mlp_relu(sd, H + "memory_embed", mem, 2)
    mem = _mln(sd, H + "spatial_alignment", mem, cone)
    gate = _lin(sd, H + "featurized_pe.conv_expand", F.relu(
        _lin(sd, H + "featurized_pe.conv_reduce", mem)))
    mpos = pos * torch.sigmoid(gate)
    ref = sd[H + "reference_points.weight"][None].expand(b, -1, 3)
    qpos = _mlp_relu(sd, H + "query_embedding", pos2posemb3d(ref, e // 2), 2)
    tgt = torch.zeros_like(qpos)
    # temporal alignment
    pc = torch.tensor(hc["pc_range"], device=dev)
    tref = (bank["reference_point"] - pc[:3]) / (pc[3:] - pc[:3])
    tpos = _mlp_relu(sd, H + "query_embedding", pos2posemb3d(tref, e // 2), 2)
    tmem = bank["embedding"]
    eye = torch.eye(4, device=dev)[:3].reshape(1, 1, 12)
    if hc["with_ego_pos"]:
        rec = nerf_pe(torch.cat([torch.zeros_like(ref),
                                 eye.expand(b, ref.shape[1], 12)], -1))
        tgt = _mln(sd, H + "ego_pose_memory", tgt, rec)
        qpos = _mln(sd, H + "ego_pose_pe", qpos, rec)
        mm = nerf_pe(torch.cat([bank["velo"], bank["timestamp"],
                                bank["egopose"][..., :3, :].flatten(-2)], -1))
        tpos = _mln(sd, H + "ego_pose_pe", tpos, mm)
        tmem = _mln(sd, H + "ego_pose_memory", tmem, mm)
    te = lambda t: _ln(sd, H + "time_embedding.1", _lin(
        sd, H + "time_embedding.0", pos2posemb1d(t, e)), LN_EPS)
    qpos = qpos + te(torch.zeros_like(ref[..., :1]))
    tpos = tpos + te(bank["timestamp"])
    p = hc["num_propagated"]
    tgt = torch.cat([tgt, tmem[:, :p]], 1)
    qpos = torch.cat([qpos, tpos[:, :p]], 1)
    ref = torch.cat([ref, tref[:, :p]], 1)
    tmem, tpos = tmem[:, p:], tpos[:, p:]
    # decoder: only the last layer's output is decoded and stored
    dc = hc["decoder"]
    q = tgt
    for i in range(dc["num_layers"]):
        q = decoder_layer(sd, H + f"transformer.decoder.layers.{i}.",
                          dc["num_heads"], q, mem, qpos, mpos, tmem, tpos)
    out = _ln(sd, H + "transformer.decoder.post_norm", q, LN_EPS)
    logits = _cls_branch(sd, out)
    reg = _reg_branch(sd, out)
    xyz = torch.sigmoid(reg[..., :3] + inverse_sigmoid(ref.clamp(0, 1)))
    boxes = torch.cat([xyz * (pc[3:] - pc[:3]) + pc[:3], reg[..., 3:]], -1)
    bank = post_update_memory(hc, bank, frame, logits, boxes, out)
    return logits, boxes, out, bank


def post_update_memory(hc, bank, frame, logits, boxes, out):
    b, q = logits.shape[:2]
    idx = stable_topk(torch.sigmoid(logits).amax(-1), hc["topk_proposals"])
    take = lambda t: torch.gather(t, 1, idx.reshape(
        idx.shape + (1,) * (t.dim() - 2)).expand(idx.shape + t.shape[2:]))
    rec_ego = torch.eye(4, device=logits.device).expand(b, q, 4, 4)
    new = {"embedding": take(out), "reference_point": take(boxes[..., :3]),
           "timestamp": torch.zeros_like(take(logits[..., :1])),
           "egopose": take(rec_ego.contiguous()),
           "velo": take(boxes[..., -2:])}
    L = hc["memory_len"]
    m = {k: torch.cat([new[k], bank[k]], 1)[:, :L] for k in BANK_KEYS}
    ego = frame["ego_pose"]
    m["reference_point"] = transform_points(m["reference_point"], ego)
    m["timestamp"] = m["timestamp"] - frame["timestamp"][:, None, None]
    m["egopose"] = torch.einsum("bij,bljk->blik", ego, m["egopose"])
    return m


def decode_boxes(boxes):
    """10-d codes (centre, log size, sin / cos yaw, velocity) -> 9-d
    bottom-centre boxes (x, y, z, w, l, h, yaw, vx, vy)."""
    size = boxes[..., 3:6].exp()
    yaw = torch.atan2(boxes[..., 6:7], boxes[..., 7:8])
    z = boxes[..., 2:3] - size[..., 2:3] * 0.5
    return torch.cat([boxes[..., :2], z, size, yaw, boxes[..., 8:10]], -1)


@torch.no_grad()
def frame_forward(sd, cfg, frame, bank):
    """One frame. frame: tensors (img uint8 (B, N, H, W, 3), intrinsics,
    img2lidar, timestamp, ego_pose, ego_pose_inv, prev_exists) on the
    device; bank: {name: tensor} going into the frame. Returns
    ({"logits": (B, Q, classes), "boxes": (B, Q, 9) bottom-centre, "code":
    (B, Q, 10) with metric centres, "centre": (B, Q, 3) those centres in
    the global frame that the bank keeps, "queries": (B, Q, C) decoder
    outputs}, the bank after it)."""
    b, n = frame["img"].shape[:2]
    feats = backbone(sd, cfg, frame["img"], bank, frame)
    f = neck(sd, feats)
    f = f.reshape(b, n, f.shape[1], f.shape[2], -1)
    logits, boxes, out, bank = head(sd, cfg, f, frame, bank)
    return {"logits": logits, "boxes": decode_boxes(boxes), "code": boxes,
            "centre": transform_points(boxes[..., :3], frame["ego_pose"]),
            "queries": out}, bank


def empty_bank(cfg, batch, device):
    hc = cfg["head"]
    L, e = hc["memory_len"], hc["embed_dims"]
    z = lambda *s: torch.zeros(*s, device=device)
    return {"embedding": z(batch, L, e), "reference_point": z(batch, L, 3),
            "timestamp": z(batch, L, 1), "egopose": z(batch, L, 4, 4),
            "velo": z(batch, L, 2)}
