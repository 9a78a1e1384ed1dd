"""Device milliseconds of the captured program 'backbone+neck' a frame
(the program's stage timer: CUDA events around its replay), mean over the
window."""
LAYER = "captured frame: runtime/graphs.CapturedInfer, program backbone+neck"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("backbone+neck")
    return sum(xs) / len(xs) if xs else None
