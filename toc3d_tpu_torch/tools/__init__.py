"""Command-line entry points of the port (twins of tools/*.py): ``python3
-m toc3d_tpu_torch.tools.test`` (streaming eval), ``python3 -m
toc3d_tpu_torch.tools.track`` (tracking on a submission) and ``python3 -m
toc3d_tpu_torch.tools.train`` (training)."""
