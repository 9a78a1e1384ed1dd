"""nuScenes temporal info pkls with their 2D annotations (twin of
tools/create_data_nusc.py; data/convert.py holds the converter):

    python3 -m toc3d_tpu_torch.tools.create_data_nusc \\
        --data-root data/nuscenes --version v1.0-trainval \\
        [--out-dir DIR] [--val-scenes val_scenes.txt]

Reads the raw nuScenes JSON tables without the devkit. The official
train/val split comes from the devkit when it is installed; else
``--val-scenes FILE`` (one scene name per line) gives the val scenes, or
every sample goes to the val pkl. Host-only: no device is involved.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--val-scenes", default=None,
                    help="file with one val scene name per line")
    return ap.parse_args(argv)


def main(argv=None):
    """Write the pkls; returns their paths."""
    args = parse_args(argv)
    from ..data.convert import create_nuscenes_infos

    val_names = None
    if args.val_scenes:
        with open(args.val_scenes) as f:
            val_names = {line.strip() for line in f if line.strip()}
    paths = create_nuscenes_infos(args.data_root, args.version, args.out_dir,
                                  val_names)
    for p in paths:
        print("wrote", p)
    return paths


if __name__ == "__main__":
    main()
