"""Device milliseconds of the stage 'decoder' inside the program
'head+decode' a frame (the transformer decoder, its attention on kernel D;
the program's stage timer), mean over the window."""
LAYER = "decoder: models/petr_transformer.decoder_forward"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("head+decode/decoder")
    return sum(xs) / len(xs) if xs else None
