"""Device milliseconds a frame of VoVNet's high-resolution part: the stage
spans 'stem', 'stage2' and 'stage3' inside the program 'backbone+neck'
(strides 2 to 8, memory-leaning convolutions; the program's stage timer),
each summed over the window, added, and divided by its frames. None for a
backbone without these spans."""
LAYER = "VoVNet: models/vovnet.vovnet_forward on ops/cuda/conv"
MOVES = "frames_per_s"
SPANS = ("stem", "stage2", "stage3")


def read(ctx):
    xs = [ctx.stages.get(f"backbone+neck/{s}") for s in SPANS]
    if not all(xs) or not ctx.frames:
        return None
    return sum(sum(x) for x in xs) / ctx.frames
