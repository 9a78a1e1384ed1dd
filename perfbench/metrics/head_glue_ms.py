"""Device milliseconds a frame of the program 'head+decode' outside its
decoder (position embedding, temporal alignment, bank update, decode and
the output copies): the program's mean less the decoder's (the program's
stage timer)."""
LAYER = "head glue: models/streampetr_head outside the decoder"
MOVES = "frames_per_s"


def read(ctx):
    head = ctx.stages.get("head+decode")
    dec = ctx.stages.get("head+decode/decoder")
    if not head or not dec:
        return None
    return sum(head) / len(head) - sum(dec) / len(dec)
