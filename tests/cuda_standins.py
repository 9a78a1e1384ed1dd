"""CPU stand-ins for the CUDA stream and graph calls of the streamed-frame
runner (runtime/capture.FrameRunner): a capture runs its function (on the
CPU it computes) and a replay does nothing, so a test sees which programs
a front end captures, keeps and drops, not what a replay computes (the card
tests check that). Imports neither JAX nor the JAX package, so a spawned
rank can install them too."""
import contextlib

import torch


class _Stream:
    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        pass


def install(setattr_):
    """Put the stand-ins in place with ``setattr_(obj, name, value)``
    (pytest's ``monkeypatch.setattr``, or ``setattr`` in a process of its
    own)."""
    setattr_(torch.cuda, "Stream", _Stream)
    setattr_(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    setattr_(torch.cuda, "current_stream", lambda d=None: _Stream())
    setattr_(torch.cuda, "graph",
             lambda g, pool=None, stream=None: contextlib.nullcontext())
    setattr_(torch.cuda, "CUDAGraph", _Graph)
    setattr_(torch.cuda, "graph_pool_handle", lambda: None)
