"""Operations and bytes of one frame, counted from the configuration file
and the traffic alone (never from what the program launches), and the
card's published peaks.

A product of an (M, K) and a (K, N) matrix is 2 M N K operations.
Elementwise work (softmax, LayerNorm, activations, RoPE) is not counted, so
every count is a floor of what the model needs and a share of a peak built
on it cannot pass 100% by the counting.

Token grid: a view of H x W pixels has (H / p) x (W / p) tokens at patch
size p. A window block partitions the grid into ws x ws windows, the last
ones padded. A full block needs its projections and MLP on the real tokens
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

# NVIDIA H100 SXM, dense (NVIDIA's data sheet), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of the operations over
    the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def grid(cfg: dict, views: int, batch: int):
    """(maps, h, w): token maps of one frame and their size."""
    p = cfg["backbone"]["patch_size"]
    hh, ww = cfg["pad_shape"]
    return batch * views, hh // p, ww // p


def keep_count(n: int, ratio: float, mxu_align: bool) -> int:
    k = int(n * ratio)
    if mxu_align and k > 1 and (k + 1) % 128 == 1:
        k -= 1
    return k


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


def mm(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def block_gemms(cfg: dict, rows: int):
    """[(label, M, N, K)] of one block's weight products on ``rows`` rows:
    q, k, v together, the output projection, the SwiGLU's two gates
    together, and w3."""
    c = cfg["backbone"]["embed_dim"]
    hid = int(c * cfg["backbone"]["mlp_ratio"])
    return [("qkv", rows, 3 * c, c), ("o", rows, c, c),
            ("gate", rows, 2 * hid, c), ("w3", rows, c, hid)]


def model_flops(cfg: dict, views: int, batch: int) -> float:
    """Operations of one steady frame (prev_exists 1): the backbone's patch
    embedding, blocks and selectors, the neck, the head's position and
    memory embeddings, its decoder and the last layer's branches."""
    bc, hc = cfg["backbone"], cfg["head"]
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
    e = hc["embed_dims"]
    total += mm(tokens, 4 * e, hc["depth_num"] * 3) + mm(tokens, e, 4 * e)
    total += 2 * mm(tokens, e, hc["in_channels"])          # memory_embed
    total += 2 * mm(tokens, e, e) + 2 * mm(tokens, e, e)   # MLN, SE gate
    qs = hc["num_query"] + hc["num_propagated"]             # a lane's
    keys = qs + hc["memory_len"] - hc["num_propagated"]
    q = qs * batch
    dc = hc["decoder"]
    per_layer = (mm(q, e, e) + 2 * mm(keys * batch, e, e)  # self q, k, v
                 + 2 * mm(q, keys, e) + mm(q, e, e)         # core, out
                 + mm(q, e, e) + 2 * mm(tokens, e, e)       # cross q, k, v
                 + 2 * mm(q, tokens // batch, e) + mm(q, e, e)
                 + mm(q, dc["feedforward_channels"], e) * 2)
    total += dc["num_layers"] * per_layer
    total += mm(q, e, e) * 4 + mm(q, hc["num_classes"], e) + \
        mm(q, hc["code_size"], e)
    return total
