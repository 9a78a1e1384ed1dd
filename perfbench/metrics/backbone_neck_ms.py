"""Device milliseconds of the captured program 'backbone+neck' a frame
(the program's stage timer: a begin and an end stamp of the card's global
timer, csrc/stamp.cu, captured into the program's graph), mean over the
window."""
LAYER = "captured frame: runtime/graphs.CapturedInfer, program backbone+neck"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("backbone+neck")
    return sum(xs) / len(xs) if xs else None
