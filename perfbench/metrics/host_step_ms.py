"""Host milliseconds of one step() call (queueing a frame: its input
copies and the replays of the captured programs), mean over the window."""
LAYER = "host loop: perfbench -> models/detector.make_infer_fn"
MOVES = "frame_p95_ms"


def read(ctx):
    if not ctx.step_s:
        return None
    return 1e3 * sum(ctx.step_s) / len(ctx.step_s)
