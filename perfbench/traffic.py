"""The one traffic generator: a stream of camera frames described by a
traffic file (perfbench/workloads/<traffic>.json) and drawn from the seed.

A stream file gives:
  batch, views        lanes and cameras of a frame; the image size is the
                      configuration's pad_shape
  contents            distinct image sets, cycled frame by frame
  scene_len           every scene_len-th frame starts a scene
                      (prev_exists 0), counted from the window's first frame
  timestamp           the frames' relative timestamp (s)
  rig                 the camera rig: focal (px), principal point cx, cy
                      (px), height (m) above the lidar origin, each view's
                      yaw (deg, 0 = forward, counter-clockwise), and the
                      standard deviation (deg) of the seeded noise on each
                      view's yaw in each content
  warm                prev_exists of the set-up frames, in order; both
                      values, so both captured programs are built in set-up
  trace_frames        frames streamed under the profiler after the window
                      in a --trace 1 run
  check_scene_starts  scene starts of the window compared with the reference
                      from an empty bank
  check_mid_frames    mid-scene frames of the window compared with the
                      reference from the bank the program carried into them

Frames are built on the host, uint8 BGR images and float32 poses (bench.py's
make_frame), held in pinned memory when asked, and shared between the
frames of one content: a frame is (content, prev_exists).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load(name: str, root: Path) -> dict:
    """The traffic file ``name`` of the checkout at ``root``."""
    return json.loads((root / "perfbench" / "workloads" / f"{name}.json")
                      .read_text())


def rig(p: dict, b: int, n: int, rng):
    """(intrinsics, img2lidar), each (b, n, 4, 4) float32, of a surround
    rig of pinhole cameras: lidar x forward, y left, z up; camera x right, y
    down, z along the view."""
    k = np.eye(4)
    k[0, 0] = k[1, 1] = p["focal"]
    k[0, 2], k[1, 2] = p["cx"], p["cy"]
    intr = np.tile(k.astype(np.float32), (b, n, 1, 1))
    i2l = np.empty((b, n, 4, 4), np.float32)
    for lane in range(b):
        for v in range(n):
            yaw = np.deg2rad(p["yaws_deg"][v] + rng.normal() * p["jitter_deg"])
            fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
            rot = np.stack([right, [0.0, 0.0, -1.0], fwd])
            l2c = np.eye(4)
            l2c[:3, :3] = rot
            l2c[:3, 3] = -rot @ np.array([0.0, 0.0, p["height"]])
            i2l[lane, v] = np.linalg.inv(k @ l2c)
    return intr, i2l


class Stream:
    """Frames of one run: ``frame(i)`` is window frame i, ``warm_frame(j)``
    set-up frame j; both are dicts of host tensors."""

    def __init__(self, params: dict, cfg: dict, seed: int, pin: bool):
        import torch
        self.p = params
        b, n = params["batch"], params["views"]
        h, w = cfg["pad_shape"]
        rng = np.random.default_rng(int(seed))
        self.contents = []
        for _ in range(params["contents"]):
            intr, img2lidar = rig(params["rig"], b, n, rng)
            ego = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
            c = {"img": rng.integers(0, 256, (b, n, h, w, 3), dtype=np.uint8),
                 "intrinsics": intr, "img2lidar": img2lidar,
                 "timestamp": np.full((b,), params["timestamp"], np.float32),
                 "ego_pose": ego, "ego_pose_inv": ego.copy()}
            c = {k: torch.from_numpy(v) for k, v in c.items()}
            self.contents.append({k: v.pin_memory() if pin else v
                                  for k, v in c.items()})
        self.flags = {}
        for pe in (0.0, 1.0):
            t = torch.full((b,), pe, dtype=torch.float32)
            self.flags[pe] = t.pin_memory() if pin else t

    def schedule(self, i: int):
        """(content, prev_exists) of window frame i."""
        return i % self.p["contents"], \
            0.0 if i % self.p["scene_len"] == 0 else 1.0

    def _frame(self, content: int, pe: float):
        return dict(self.contents[content], prev_exists=self.flags[pe])

    def frame(self, i: int):
        return self._frame(*self.schedule(i))

    def warm_frame(self, j: int):
        return self._frame(j % self.p["contents"], float(self.p["warm"][j]))
