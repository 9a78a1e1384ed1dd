"""The port's nuScenes info converter (toc3d_tpu_torch/data/convert.py and
its CLI, toc3d_tpu_torch/tools/create_data_nusc.py) against the JAX
package's on tests/test_convert.py's raw tables: equal infos (arrays with
np.array_equal, NaN equal to NaN), equal pkl files with and without a
val split, the pkl read by the port's NuScenesInfos as JAX's reads JAX's,
the 2D hull post-processing, and the CLI. Everything here is host numpy.
"""
import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.data import convert as jconvert
from toc3d_tpu.data.nuscenes import NuScenesInfos as JNuScenesInfos

from test_convert import make_raw_tables

from toc3d_tpu_torch.data import convert as tconvert
from toc3d_tpu_torch.data.nuscenes import NuScenesInfos
from toc3d_tpu_torch.tools import create_data_nusc

VERSION = "v1.0-synth"


def assert_same(a, b, path="infos"):
    """a and b equal, recursively: dicts key for key, sequences item for
    item, arrays by dtype, shape and np.array_equal (NaN equal to NaN)."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_raw_tables(str(tmp_path_factory.mktemp("nusc")), n_samples=4)


def test_fill_trainval_infos_equals_jax(root):
    got = tconvert.fill_trainval_infos(tconvert.NuScenesTables(root, VERSION))
    want = jconvert.fill_trainval_infos(jconvert.NuScenesTables(root,
                                                                VERSION))
    assert len(got) == 4
    assert_same(got, want)
    # the test split writes no annotation
    got = tconvert.fill_trainval_infos(tconvert.NuScenesTables(root, VERSION),
                                       test=True)
    want = jconvert.fill_trainval_infos(jconvert.NuScenesTables(root,
                                                                VERSION),
                                        test=True)
    assert "gt_boxes" not in got[0]
    assert_same(got, want)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("val", [None, {"scene-0001"}, {"scene-0999"}])
def test_create_nuscenes_infos_equals_jax(root, tmp_path, val):
    """The same file names and pkls that load to equal dicts: without a
    split every sample goes to the val pkl; with one, the named scenes to
    val and the rest to train."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tconvert.create_nuscenes_infos(root, VERSION,
                                         str(tmp_path / "port"), val)
    want = jconvert.create_nuscenes_infos(root, VERSION,
                                          str(tmp_path / "jax"), val)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for a, b in zip(got, want):
        assert_same(_load(a), _load(b), os.path.basename(a))
    if val:
        split = dict(zip(("train", "val"), (len(_load(p)["infos"])
                                            for p in got)))
        assert split == ({"train": 0, "val": 4} if "scene-0001" in val
                         else {"train": 4, "val": 0})


def test_port_pkl_feeds_port_reader(root, tmp_path):
    """The port's pkl, read by the port's NuScenesInfos, gives JAX's
    frame_meta, annotations and prev_exists on JAX's pkl."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    [got] = tconvert.create_nuscenes_infos(root, VERSION,
                                           str(tmp_path / "port"))
    [want] = jconvert.create_nuscenes_infos(root, VERSION,
                                            str(tmp_path / "jax"))
    port, ref = NuScenesInfos(got), JNuScenesInfos(want)
    assert len(port) == len(ref) == 4
    for i in range(len(ref)):
        assert_same(port.frame_meta(i), ref.frame_meta(i), f"meta {i}")
        assert_same(port.annotations(i), ref.annotations(i), f"ann {i}")
        assert port.prev_exists(i) == ref.prev_exists(i)


def test_post_process_coords_equals_jax():
    """The hull-canvas intersection on tests/test_convert.py's cases (inside,
    a diagonal across the canvas, off the canvas, a triangle over the left
    edge) and on 200 seeded point sets around the canvas."""
    cases = [np.array([[10, 20], [200, 50], [120, 300], [30, 250]], float),
             np.array([[-100, 0], [1700, 900]], float),
             np.array([[-50, -50], [-10, -20]], float),
             np.array([[-100, 100], [100, 100], [100, 300]], float)]
    rng = np.random.RandomState(0)
    cases += [rng.uniform(-400, 2000, (rng.randint(1, 9), 2))
              for _ in range(200)]
    hits = 0
    for pts in cases:
        got = tconvert.post_process_coords(pts)
        assert got == jconvert.post_process_coords(pts)
        hits += got is not None
    assert 0 < hits < len(cases)
    x1, y1, x2, y2 = tconvert.post_process_coords(cases[1])
    assert (x1, x2) == (0.0, 1600.0)
    assert abs(y1 - 50.0) < 1e-6 and abs(y2 - 850.0) < 1e-6


def test_cli_writes_jax_files(root, tmp_path, capsys):
    """``python -m toc3d_tpu_torch.tools.create_data_nusc`` in-process with
    --val-scenes: the files and pkls JAX's converter writes."""
    scenes = tmp_path / "val.txt"
    scenes.write_text("scene-0001\n\n")
    out = tmp_path / "cli"
    out.mkdir()
    paths = create_data_nusc.main(["--data-root", root, "--version", VERSION,
                                   "--out-dir", str(out), "--val-scenes",
                                   str(scenes)])
    text = capsys.readouterr().out
    assert sorted(os.listdir(out)) == [
        "nuscenes2d_temporal_infos_train.pkl",
        "nuscenes2d_temporal_infos_val.pkl"]
    assert all(f"wrote {p}" in text for p in paths)
    (tmp_path / "jax").mkdir()
    want = jconvert.create_nuscenes_infos(root, VERSION, str(tmp_path / "jax"),
                                          {"scene-0001"})
    for a, b in zip(paths, want):
        assert_same(_load(a), _load(b))
