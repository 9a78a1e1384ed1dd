"""Serving runtime of the port: the streaming frame as captured CUDA graphs
(graphs) and per-stage timing with CUDA events (timer)."""
