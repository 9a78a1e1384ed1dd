"""Plain float32 reference of one streaming frame of ToC3D / StreamPETR
(the published mmdet3d models): the image encoder that the configuration
file names (perfbench/encoders: the backbone and neck, image normalisation
included), then the part every encoder shares, the StreamPETR head with
its memory bank and the NMS-free decode.

Written from the published description and the reference code's equations,
in plain PyTorch, float32 only; it imports nothing of the measured program
and takes only a state dict of reference (mmdet3d) names, the configuration
file's sizes, a frame and the memory bank going into it. Call
``set_plain_math()`` first on a GPU: TF32 off, so every float32 product is
float32.

The head, as the reference code has it, aligns the bank to the current ego
frame, resets it where prev_exists is 0, splices the first num_propagated
slots into the queries, runs the post-norm decoder (self-attention over
queries and memory, cross-attention over every image token) and pushes the
best topk_proposals queries into the bank. The small pieces below are
shared with the encoders.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import encoders

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
    f = encoders.load(cfg).features(sd, cfg, frame["img"], bank, frame)
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
