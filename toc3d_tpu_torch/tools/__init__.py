"""Command-line entry points of the port (twins of tools/*.py): ``python3
-m toc3d_tpu_torch.tools.test`` (streaming eval), ``python3 -m
toc3d_tpu_torch.tools.track`` (tracking on a submission), ``python3 -m
toc3d_tpu_torch.tools.train`` (training), ``python3 -m
toc3d_tpu_torch.tools.traineval`` (the closed loop) and ``python3 -m
toc3d_tpu_torch.tools.export`` (the serving artifact)."""
