"""Device milliseconds a frame of VoVNet's low-resolution part: the stage
spans 'stage4' and 'stage5' inside the program 'backbone+neck' (strides 16
and 32: the compute-bound convolutions and the launch-bound ones; the
program's stage timer), each summed over the window, added, and divided by
its frames. None for a backbone without these spans."""
LAYER = "VoVNet: models/vovnet.vovnet_forward on ops/cuda/conv"
MOVES = "frames_per_s"
SPANS = ("stage4", "stage5")


def read(ctx):
    xs = [ctx.stages.get(f"backbone+neck/{s}") for s in SPANS]
    if not all(xs) or not ctx.frames:
        return None
    return sum(sum(x) for x in xs) / ctx.frames
