"""Kernel G's share of its roofline (perfbench/rooflines/gemm_bf16.py)."""
from .. import rooflines

LAYER = "kernels"
MOVES = "frames_per_s"


def read(ctx):
    return rooflines.share(ctx, "gemm_bf16")
