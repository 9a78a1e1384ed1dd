"""Multi-GPU layer of the port (counterpart of toc3d_tpu/parallel/): the
process group, the data-parallel collectives and the gradient all-reduce
(mesh), and view-sharded streaming inference over process groups
(infer_spmd)."""
