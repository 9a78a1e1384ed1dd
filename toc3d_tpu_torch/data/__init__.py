"""Data pipeline of the port: nuScenes infos, eval frames, the eval
sampler and the learnable synthetic scenes (counterpart of toc3d_tpu/data)."""
