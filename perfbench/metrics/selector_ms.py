"""Device milliseconds a frame of the ToC3D token selectors, the stage
'select' inside the program 'backbone+neck' (each selector's scores and
mask; the program's stage timer), summed over the window and divided by
its frames. None for a backbone without selectors."""
LAYER = "token selectors: models/toc3d_vit -> models/token_select"
MOVES = "frames_per_s"


def read(ctx):
    xs = ctx.stages.get("backbone+neck/select")
    return sum(xs) / ctx.frames if xs and ctx.frames else None
