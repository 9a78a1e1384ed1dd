"""Device milliseconds a frame of the neck, the stage span 'neck' inside
the program 'backbone+neck' (models/neck.cpfpn_forward: one or two levels;
the program's stage timer), mean over the window. None where the program
has no such span."""
LAYER = "neck: models/neck.cpfpn_forward"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("backbone+neck/neck")
    return sum(xs) / len(xs) if xs else None
