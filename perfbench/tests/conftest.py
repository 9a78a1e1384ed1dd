"""Shared pieces of the benchmark's own tests (CPU, tiny sizes; the tests
marked ``cuda`` need a card and skip without one)."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_CELL = "tiny.stream_b1"
TINY_LIMITS = {"emb_med": 1e-4, "size_rms": 1e-4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_config_file(**overrides) -> dict:
    """The program's 'tiny' preset as a configuration file."""
    from toc3d_tpu_torch.configs import get_config
    from perfbench.program import _plain
    cfg = {"name": "tiny", "preset": "tiny", "views": 6, "reduced": [],
           "source": "the program's tiny preset", "why": "CPU tests",
           "assumed": {}, "encoder": "eva_vit"}
    cfg.update(_plain(dataclasses.asdict(get_config("tiny"))))
    cfg.update(overrides)
    return cfg


def add_tiny_cell(root: Path, bench: dict) -> dict:
    """Add a tiny cell to the checkout at ``root`` as new files only (a
    configuration, a limits file) and entries of ``bench``."""
    (root / "perfbench/configs/tiny.json").write_text(
        json.dumps(tiny_config_file()))
    (root / f"perfbench/cells/{TINY_CELL}.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny",
                               "traffic": "stream_b1", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY_CELL)
    return bench


@pytest.fixture
def tiny_checkout(tmp_path):
    """(root, bench): a copy of BENCHMARK.json and perfbench/ with the tiny
    cell added."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    add_tiny_cell(root, bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench
