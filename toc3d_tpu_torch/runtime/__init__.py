"""Runtime of the port: the streaming frame as captured CUDA graphs
(graphs), per-stage timing with CUDA events (timer), the streaming eval and
submission writer (eval), the detection metrics (nusc_metrics), the token
visualizer (token_vis), training (train, checkpoint) and the export of the
streaming detector as torch.export programs (export)."""
