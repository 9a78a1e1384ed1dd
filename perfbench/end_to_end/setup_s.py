"""Seconds from the process's start to the first timed frame: imports,
the kernels' build (served from the checkout's build directory after a
cell's first run), weights, frames, the captures and the warm frames."""


def read(run):
    return run.setup_s
