"""Device milliseconds of the span 'inputs' a frame: the frame's and the
memory bank's copies into the captured programs' static buffers (the
program's stage timer), mean over the window."""
LAYER = "captured frame: runtime/graphs.CapturedInfer, input copies"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("inputs")
    return sum(xs) / len(xs) if xs else None
