"""Percent of the traced frames' wall time in which no operation ran on
the card: 1 - (union of the device's kernel and copy intervals) / traced
window."""
LAYER = "device"
MOVES = "frames_per_s"


def read(ctx):
    if not ctx.kernels or ctx.trace_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace_s)
