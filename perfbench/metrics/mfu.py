"""The whole frame's share of the card's bf16 peak: the model's operations
a steady frame, counted from the configuration (perfbench/counting.py),
times the window's frames over its seconds, over 989 TFLOP/s."""
from .. import counting

LAYER = "the whole frame"
MOVES = "frames_per_s"


def read(ctx):
    if not ctx.frames or ctx.window_s <= 0:
        return None
    flops = counting.model_flops(ctx.cfg, ctx.views, ctx.batch)
    return 100.0 * flops * ctx.frames / ctx.window_s / \
        counting.PEAK_BF16_FLOPS
