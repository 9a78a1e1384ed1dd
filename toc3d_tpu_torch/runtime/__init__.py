"""Runtime of the port: the streaming frame as captured CUDA graphs
(graphs), per-stage timing with CUDA events (timer), the streaming eval and
submission writer (eval), the detection metrics (nusc_metrics) and the
token visualizer (token_vis)."""
