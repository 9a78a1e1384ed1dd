"""Frames whose boxes reached the host in the window, over the window's
seconds (its start to the last frame's boxes on the host)."""


def read(run):
    return run.frames / run.window_s if run.frames else None
