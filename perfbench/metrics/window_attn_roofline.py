"""Window attention's share of its roofline
(perfbench/rooflines/window_attention.py)."""
from .. import rooflines

LAYER = "kernels"
MOVES = "frames_per_s"


def read(ctx):
    return rooflines.share(ctx, "window_attention")
