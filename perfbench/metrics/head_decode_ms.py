"""Device milliseconds of the captured program 'head+decode' a frame (the
program's stage timer), mean over the window."""
LAYER = "captured frame: runtime/graphs.CapturedInfer, program head+decode"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("head+decode")
    return sum(xs) / len(xs) if xs else None
