"""The port's visualizer (toc3d_tpu_torch/tools/visualize.py) against the
JAX package's tools/visualize.py on tests/test_visualize.py's synthetic
scenes and detections: the BEV panel, each camera (with and without score
labels) and the render_sample-style composite pixel for pixel, each side
with its own build_gt_from_infos (runtime/nusc_metrics.py), and
``main`` writing the files tools/visualize.py writes, with equal pixels.
Host-side PIL, on the CPU.
"""
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import visualize as jvis
from toc3d_tpu.runtime.nusc_metrics import \
    build_gt_from_infos as jax_build_gt

from test_visualize import _dataset_and_results

from toc3d_tpu_torch.runtime.nusc_metrics import build_gt_from_infos
from toc3d_tpu_torch.tools import visualize as tvis


def _same(a, b):
    assert a.size == b.size and a.mode == b.mode
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    infos, results = _dataset_and_results(root)
    return root, infos, results


def test_palette_equals_jax():
    assert tvis.COLORS == jvis.COLORS and tvis.GT_COLOR == jvis.GT_COLOR
    assert tvis.EDGES == jvis.EDGES and tvis.CAM_LAYOUT == jvis.CAM_LAYOUT


@pytest.mark.parametrize("idx", [0, 1])
def test_renderers_pixel_equal_jax(scenes, idx):
    _, infos, results = scenes
    info = infos[idx]
    annos = results[info["token"]]
    gt = build_gt_from_infos(infos[:2])[info["token"]]
    jgt = jax_build_gt(infos[:2])[info["token"]]
    assert annos and gt
    bev = tvis.render_bev(info, annos, gt, bev_range=30.0, size=256)
    _same(bev, jvis.render_bev(info, annos, jgt, bev_range=30.0, size=256))
    assert (np.asarray(bev).reshape(-1, 3) == tvis.GT_COLOR).all(1).any()
    for name, cam in info["cams"].items():
        for labels in (True, False):
            _same(tvis.render_camera(info, cam, annos, gt,
                                     score_labels=labels),
                  jvis.render_camera(info, cam, annos, jgt,
                                     score_labels=labels))
    comp = tvis.render_sample_composite(info, annos, gt, bev_range=30.0,
                                        tile_w=160)
    _same(comp, jvis.render_sample_composite(info, annos, jgt,
                                             bev_range=30.0, tile_w=160))
    assert np.asarray(comp).any()


@pytest.mark.parametrize("extra", [[], ["--composite"]])
def test_main_writes_jax_files(scenes, tmp_path, monkeypatch, extra):
    """The port's main(argv) and tools/visualize.py's main (sys.argv)
    write the same files, image for image."""
    root, infos, results = scenes
    res = tmp_path / "results_nusc.json"
    res.write_text(json.dumps({"results": results}))
    args = ["--results", str(res), "--ann",
            os.path.join(str(root), "infos.pkl"), "--num-samples", "2",
            "--score-thresh", "0.5", "--bev-range", "40"] + extra
    tvis.main(args + ["--out-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["visualize.py"] + args + [
        "--out-dir", str(tmp_path / "jax")])
    jvis.main()
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == (2 if extra else 2 * (1 + len(infos[0]["cams"])))
    for f in files:
        with Image.open(tmp_path / "port" / f) as a, \
                Image.open(tmp_path / "jax" / f) as b:
            _same(a, b)
