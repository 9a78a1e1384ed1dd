"""Kernel G (``gemm_sm90_kernel``): every bf16 weight product of the
blocks B and C (q, k, v together; the output projection; the SwiGLU's two
gates together; w3) and the patch embedding's product. Bytes: the
activation, the weight and the product, each once, in bf16; every launch
here is bound by its operations."""
from __future__ import annotations

from .. import counting
from ..encoders import eva_vit

MATCH = "gemm_sm90_kernel"
EXCLUDE = ("gemm_s8",)


def launches(cfg, views, batch):
    maps, h, w = eva_vit.grid(cfg, views, batch)
    c = cfg["backbone"]["embed_dim"]
    p = cfg["backbone"]["patch_size"]
    shapes = [("patch", maps * h * w, c, 3 * p * p)]
    for blk in eva_vit.blocks(cfg, views, batch):
        shapes += eva_vit.block_gemms(cfg, blk["rows"])
    return [(lab, counting.mm(m, n, k), 2.0 * (m * k + k * n + m * n))
            for lab, m, n, k in shapes]
