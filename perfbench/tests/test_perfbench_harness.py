"""The harness: what it loads, that a cell, a traffic mix, a configuration
and a per-layer metric are added as new files only, the trace reduction,
and (on a card) one short run of each cell."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench import trace
from perfbench.tests.conftest import REPO, TINY_CELL

FORBIDDEN = {"jax", "jaxlib", "flax", "toc3d_tpu"}


def _python(code: str, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), str(REPO)]))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_the_reference_imports_neither_jax_nor_the_program():
    out = _python(
        "import sys, perfbench.reference.model, perfbench.check, "
        "perfbench.encoders.eva_vit; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))", REPO)
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"toc3d_tpu_torch"})


def test_a_run_loads_no_jax_and_not_the_jax_package(tiny_checkout):
    """A whole tiny run on the CPU in a fresh process; module names are
    compared whole, so the port (toc3d_tpu_torch) is allowed."""
    root, _ = tiny_checkout
    out = _python(
        "import json; from pathlib import Path; "
        "from perfbench.cell import run_cell; from perfbench import run; "
        "b = json.loads(Path('BENCHMARK.json').read_text()); "
        f"r, _ = run_cell(b, {TINY_CELL!r}, 7, 0.5, False, 'cpu', Path('.')); "
        "print(json.dumps([r['correct'], run.forbidden_modules()]))", root)
    assert json.loads(out) == [True, []]
    out = _python("import sys, types; from perfbench import run; "
                  "sys.modules['toc3d_tpu.models'] = types.ModuleType('x'); "
                  "print(run.forbidden_modules())", root)
    assert out == "['toc3d_tpu']"


def test_new_cell_traffic_and_metric_are_new_files_only(tiny_checkout):
    """A traffic mix, a cell on it and a per-layer metric, each added as a
    file with an entry in BENCHMARK.json; no file of the harness edited."""
    root, bench = tiny_checkout
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*.py")}
    mix = json.loads((root / "perfbench/workloads/stream_b1.json")
                     .read_text())
    mix["scene_len"] = 10
    (root / "perfbench/workloads/stream_short_scenes.json").write_text(
        json.dumps(mix))
    (root / "perfbench/cells/tiny.short_scenes.json").write_text(
        json.dumps({"limits": {"emb_med": 1e-4}}))
    (root / "perfbench/metrics/frames_in_window.py").write_text(
        'LAYER = "host loop"\nMOVES = "frames_per_s"\n\n\n'
        'def read(ctx):\n    return float(ctx.frames)\n')
    bench["workloads"].append({"name": "tiny.short_scenes", "config": "tiny",
                               "traffic": "stream_short_scenes", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "host loop", "moves": "frames_per_s",
                               "workloads": ["tiny.short_scenes"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(
        "import json; from pathlib import Path; "
        "from perfbench.cell import run_cell; "
        "b = json.loads(Path('BENCHMARK.json').read_text()); "
        "r, _ = run_cell(b, 'tiny.short_scenes', 9, 1.0, True, 'cpu', "
        "Path('.')); r.pop('_judged'); print(json.dumps(r))", root)
    res = json.loads(out)
    assert res["correct"]
    assert res["metrics"]["frames_in_window"]["value"] == res["attempted"]
    assert set(res["checks"]) == {"emb_med"}
    assert before == {p: p.read_bytes() for p in before}


def test_busy_union_and_idle_gaps():
    kernels = [("a", 0, 10), ("b", 5, 12), ("a", 20, 30), ("c", 40, 41)]
    host = [("perfbench.step", 11, 25), ("cudaGraphLaunch", 13, 18),
            ("perfbench.fetch_wait", 30, 45)]
    assert trace.busy_intervals(kernels) == [[0, 12], [20, 30], [40, 41]]
    assert trace.busy_seconds(kernels, 0, 50) == pytest.approx(23e-6)
    assert trace.idle_gaps(kernels, host, 0, 50) == [
        ["perfbench.fetch_wait", pytest.approx(10e-6)],
        ["no host event", pytest.approx(9e-6)],
        ["perfbench.step/cudaGraphLaunch", pytest.approx(8e-6)]]
    assert trace.top_ops(kernels, 1) == [["a", pytest.approx(20e-6)]]
    assert trace.kernel_seconds(kernels, "a") == pytest.approx(20e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["toc3d_faster_1600.stream_b1",
                                      "streampetr_vitl_1600.stream_b1"])
@pytest.mark.parametrize("traced", [0, 1])
def test_one_short_run_on_the_card(cuda_card, workload, traced):
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", "4000000001", "--seconds", "2", "--trace", str(traced)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name in ("gemm_bf16_roofline", "window_attn_roofline", "mfu"):
            assert 0 < res["metrics"][name]["value"] <= 100
