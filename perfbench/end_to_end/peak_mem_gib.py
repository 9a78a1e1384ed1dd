"""torch.cuda.max_memory_allocated() over the program's set-up and the
window, in GiB; the benchmark's own copy of the weights is freed before
the reset, and the reference runs after the reading."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
