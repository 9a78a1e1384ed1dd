"""Command-line entry points of the port (twins of tools/*.py): ``python3
-m toc3d_tpu_torch.tools.test`` (streaming eval), ``python3 -m
toc3d_tpu_torch.tools.track`` (tracking on a submission), ``python3 -m
toc3d_tpu_torch.tools.train`` (training), ``python3 -m
toc3d_tpu_torch.tools.traineval`` (the closed loop), ``python3 -m
toc3d_tpu_torch.tools.export`` (the serving artifact), ``python3 -m
toc3d_tpu_torch.tools.dryrun`` (the multi-process dry run), ``python3 -m
toc3d_tpu_torch.tools.create_data_nusc`` (nuScenes info pkls from the raw
tables), ``python3 -m toc3d_tpu_torch.tools.visualize`` (detections drawn
on the cameras and a BEV panel) and ``python3 -m
toc3d_tpu_torch.tools.host_pipeline_bench`` (host, infer and end-to-end
rates over JPEGs it writes); the eval and the trainer take
``--distributed``."""
