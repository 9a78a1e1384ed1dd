"""Window attention (``window_attention_kernel``) inside B and C: per
block, softmax(q k^T) v within each window, over every head. Operations:
q k^T and p v, 4 d per query-key pair and head. A full block needs the
queries of the real tokens only, each over its window's ws^2 keys (pads
are keys); a compressed block's windows hold k + 1 rows, queries and keys.
Bytes: q, k and v read once and the output written once, ``qkv_bytes`` and
2 bytes an element (bf16 by default: the configuration's dtype)."""
from __future__ import annotations

from ..encoders import eva_vit

MATCH = "window_attention_kernel"
EXCLUDE = ()


def launches(cfg, views, batch, qkv_bytes=2):
    maps, h, w = eva_vit.grid(cfg, views, batch)
    c = cfg["backbone"]["embed_dim"]
    out = []
    for blk in eva_vit.blocks(cfg, views, batch):
        if blk["kind"] == "full":
            rows = maps * h * w
            flops = 4.0 * rows * blk["ws"] ** 2 * c
        else:
            rows = blk["rows"]
            flops = 4.0 * rows * blk["per_window"] * c
        nbytes = rows * c * (3 * qkv_bytes + 2)
        out.append((f"{blk['kind']} ws {blk['ws']}", flops, float(nbytes)))
    return out
