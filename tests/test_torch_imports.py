"""Import guard: the PyTorch port (toc3d_tpu_torch) imports neither jax nor
anything of the JAX package, its modules import without building or
loading a kernel, and PIL, cv2 and scipy are imported only where they are
used, never when a module is imported."""
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    import toc3d_tpu_torch
    names = ["toc3d_tpu_torch"]
    for m in pkgutil.walk_packages(toc3d_tpu_torch.__path__,
                                   "toc3d_tpu_torch."):
        names.append(m.name)
    return names


def test_port_imports_no_jax():
    names = _modules()
    for mod in ("ops.cuda.vit_block", "ops.cuda.int8", "ops.int8_calib",
                "bench", "runtime.graphs", "runtime.timer", "ops.consts",
                "data.nuscenes", "data.sampler", "data.loader",
                "data.synthetic", "runtime.nusc_metrics", "runtime.eval",
                "runtime.token_vis", "tracking", "tracking.pub_tracker",
                "tracking.metrics", "tools.test", "tools.track",
                "runtime.capture", "runtime.export", "runtime.checkpoint",
                "data.convert", "tools.create_data_nusc", "tools.visualize",
                "models.common", "models.petr_head_dn", "models.vovnet",
                "models.vit_simple_fpn", "ops.rel_pos",
                "tools.host_pipeline_bench"):
        assert f"toc3d_tpu_torch.{mod}" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'toc3d_tpu.')) or "
            "m == 'toc3d_tpu')\n"
            "assert not bad, bad\n"
            "lazy = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'cv2', 'scipy'))\n"
            "assert not lazy, lazy\n"
            "from toc3d_tpu_torch.ops.cuda import build\n"
            "assert not build._LIBS\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_sources_never_name_jax():
    """No module of the port has an import of jax or toc3d_tpu."""
    for f in (ROOT / "toc3d_tpu_torch").rglob("*.py"):
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "toc3d_tpu"
                            or mod.startswith("toc3d_tpu.")), (f, line)
