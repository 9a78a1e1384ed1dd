"""The stamp log's kernel (source csrc/stamp.cu), the device clock of
runtime/timer.StageTimer. It has no JAX counterpart: JAX's GlobalTimer
synchronises the device around every span and reads the host clock
(toc3d_tpu/runtime/timer.py:21).
"""
from __future__ import annotations

import time

from .build import call, stream_of


def stamp(log, count, word: int) -> None:
    """Append (word, ns) to ``log``, (capacity, 2) int64, at slot
    ``count[0]`` and add 1 to ``count``, (1,) int32, past the capacity too,
    so a full log shows how many stamps it dropped. On the card one thread
    does it on the current stream, reading the global timer (ns); launched
    during a CUDA-graph capture it becomes a node that appends anew on every
    replay. On the CPU the host's perf_counter_ns, at once."""
    if log.device.type == "cpu":
        ns = time.perf_counter_ns()
        i = int(count[0])
        count[0] = i + 1
        if i < log.shape[0]:
            log[i, 0] = word
            log[i, 1] = ns
        return
    call("stamp", "toc3d_stamp", log.data_ptr(), count.data_ptr(),
         log.shape[0], word, stream_of(log))
