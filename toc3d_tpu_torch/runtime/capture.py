"""CUDA-graph capture of one program, shared by the captured frame
(runtime/graphs.CapturedInfer) and the served export
(runtime/export.ExportedDetector). It imports no model module, so a loaded
artifact captures its programs without the model code.

A program's first use runs eagerly on a side stream and is that call's
result; it also does what a capture cannot: the kernels' shared-memory
attributes and tensor maps, cached constants and weight packs, the
libraries' handles and workspaces. The program is then captured on the same
stream into the caller's memory pool. A capture that fails raises; nothing
carries on eagerly.

Launch counters: a replay runs no Python wrapper, so each capture records
every counter's change (the capture itself launches nothing, and the
counters are put back) and each replay adds that change.
"""
from __future__ import annotations

import torch

from ..ops.cuda import counted_wrappers


class Program:
    """One captured graph, its output and the launches each replay
    makes."""

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches

    def replay(self):
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n
        return self.out


def run_captured(programs: dict, name, fn, stream, pool, device):
    """Replay ``programs[name]``; at its first use run ``fn`` eagerly on
    ``stream``, a side stream of ``device`` (the call's result), then
    capture it there into ``pool`` and keep it in ``programs``."""
    prog = programs.get(name)
    if prog is not None:
        return prog.replay()
    main = torch.cuda.current_stream(device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    counters = counted_wrappers()
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            captured = fn()
    finally:
        launches = [(f, f.launches - n) for f, n in zip(counters, before)]
        for f, n in zip(counters, before):
            f.launches = n
    programs[name] = Program(graph, captured,
                             [(f, n) for f, n in launches if n])
    return out
