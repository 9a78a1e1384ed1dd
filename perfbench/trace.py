"""Reduction of a torch.profiler trace (CUDA kernels, with those inside
CUDA-graph replays, and the host's events) to the numbers the per-layer
readers and the result's breakdown use."""
from __future__ import annotations

from collections import defaultdict


def reduce(prof):
    """-> (kernels [(name, start_us, end_us)], host [(name, start_us,
    end_us)]) from a finished profile. Copies and fills are device work
    too and count as kernels here; the benchmark's record_function ranges,
    which the profiler also draws over the device's timeline, are host
    events only."""
    import torch
    kernels, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((ev.name, tr.start, tr.end))
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name.startswith("perfbench.")):
            kernels.append((ev.name, tr.start, tr.end))
    kernels.sort(key=lambda k: k[1])
    return kernels, host


def busy_intervals(kernels):
    """The union of the kernels' intervals, as sorted disjoint
    [start, end] pairs (us)."""
    out = []
    for _, s, e in kernels:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(kernels, t0_us, t1_us) -> float:
    """Seconds of [t0, t1] in which some kernel ran."""
    tot = 0.0
    for s, e in busy_intervals(kernels):
        s, e = max(s, t0_us), min(e, t1_us)
        if e > s:
            tot += e - s
    return tot * 1e-6


def kernel_seconds(kernels, match, exclude=()) -> float:
    """Summed device seconds of the kernels whose name holds ``match`` and
    none of ``exclude``."""
    return sum(e - s for n, s, e in kernels
               if match in n and not any(x in n for x in exclude)) * 1e-6


def top_ops(kernels, n=10):
    """[[name, seconds]] of the n kernels that took the most device time
    in all, longest first."""
    tot = defaultdict(float)
    for name, s, e in kernels:
        tot[name] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, host, t0_us, t1_us, n=10):
    """[[name, seconds]] of the n longest spans of [t0, t1] with no kernel
    running, each named by what the host was doing at its middle: the
    benchmark's own span there, then the innermost host event, joined by
    '/'."""
    gaps, prev = [], t0_us
    for s, e in busy_intervals(kernels) + [[t1_us, t1_us]]:
        s = min(max(s, t0_us), t1_us)
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, min(e, t1_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        around = [h for h in host if h[1] <= mid <= h[2]]
        ours = [h for h in around if h[0].startswith("perfbench.")]
        inner = min(around, key=lambda h: h[2] - h[1], default=None)
        parts = [min(ours, key=lambda h: h[2] - h[1])[0]] if ours else []
        if inner is not None and (not ours or inner[0] != parts[0]):
            parts.append(inner[0])
        out.append(["/".join(parts) or "no host event", (b - a) * 1e-6])
    return out
