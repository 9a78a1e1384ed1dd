"""The port's export (toc3d_tpu_torch/runtime/export.py) on the CPU, case by
case as tests/test_export.py holds the JAX package's: the artifact's layout
and manifest, 3 streaming frames (the first-frame program, then the steady
one) bit for bit against ``eager_infer_fn`` in outputs and bank, a load path
that never runs the model code (no model module imported, in a fresh
process too), the int8 head with uint8 images, gumbel refused. Beyond
JAX's file: the loaded artifact against the JAX package's ``make_infer_fn``
on the same reference state dict (tiny preset, 2 views of 64x128, the
first frame's JAX cond and the steady one; tolerances as
tests/test_torch_presets.py: scores, boxes and every bank field 1e-3,
labels and validity equal, near-tied ranks in either order), the int8
backbone (B8 / C8, dynamic and calibrated static),
``torch.library.opcheck`` of every ``toc3d::`` op's CPU implementation
against its fake one at small shapes, the export CLI's self-check, and the
weight packs taken as they stand under a trace. The served detector's CUDA
path (captured graphs, runtime/capture.py): its frame checks, its programs
captured once and kept (with CPU stand-ins for the CUDA graph API, as
tests/test_torch_serving.py does), no host-sync node in a loaded program,
and its modules loaded with no model module; on the CPU a call is the
eager run. The card tests of the captured loaded programs are in
tests/test_torch_cuda.py.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.models.detector import init_state as jax_init_state
from toc3d_tpu.models.detector import make_infer_fn as jax_make_infer_fn
from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint

from test_full_converter import build_reference_state_dict
from test_parity_detector import make_frames
from test_torch_presets import _compare as compare_with_ties
from test_torch_serving import cuda_standins  # noqa: F401  (a fixture)

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.layers import quantize_linear
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
from toc3d_tpu_torch.ops.cuda import library, vit_block
from toc3d_tpu_torch.ops.int8_calib import (attach_act_scales,
                                            calibrate_act_scales)
from toc3d_tpu_torch.ops.rope import build_rope_table
from toc3d_tpu_torch.runtime.export import (FORMAT, FRAME_KEYS,
                                            ExportedDetector,
                                            export_detector, load_detector)
from toc3d_tpu_torch.tools import export as export_cli

ROOT = Path(__file__).resolve().parents[1]
BANK = ("embedding", "reference_point", "timestamp", "egopose", "velo")


def _configs(quant=()):
    """JAX's and the port's tiny preset as served (mxu_align_k), int8 in
    the named parts ('backbone', 'head')."""
    jcfg = jax_get_config("tiny")
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone, mxu_align_k=True))
    tcfg = get_config("tiny")
    tcfg = replace(tcfg, backbone=replace(
        tcfg.backbone, mxu_align_k=True,
        quant="int8" if "backbone" in quant else "none"))
    if "head" in quant:
        tcfg = replace(tcfg, head=replace(tcfg.head, decoder=replace(
            tcfg.head.decoder, quant="int8")))
    return jcfg, tcfg


def _frames(seed, uint8=False, t_total=3):
    rng = np.random.RandomState(seed)
    jcfg, _ = _configs()
    frames = make_frames(rng, jcfg, t_total=t_total)
    if uint8:
        for f in frames:
            f["img"] = rng.randint(0, 256, f["img"].shape).astype(np.uint8)
    return frames


def _equal(det_a, state_a, det_b, state_b, msg):
    for name, a, b in zip(td.DecodedBoxes._fields, det_a, det_b):
        assert torch.equal(a, b), f"{msg}: {name}"
    for name, a, b in zip(BANK, state_a.memory, state_b.memory):
        assert torch.equal(a, b), f"{msg}: memory {name}"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    jcfg, tcfg = _configs()
    sd = build_reference_state_dict(jcfg, np.random.RandomState(3))
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    out = str(tmp_path_factory.mktemp("export") / "tiny")
    manifest = export_detector(model, out, batch_size=1, num_views=2)
    return jcfg, sd, model, out, manifest


def test_artifact_layout(artifact):
    _, _, model, out, manifest = artifact
    assert sorted(os.listdir(out)) == [
        "backbone_first.pt2", "backbone_steady.pt2", "head.pt2",
        "manifest.json", "memory.pt", "weights.pt"]
    on_disk = json.load(open(os.path.join(out, "manifest.json")))
    assert on_disk == manifest
    assert on_disk["format"] == FORMAT
    assert on_disk["pad_shape"] == [64, 128]
    assert list(on_disk["frame_specs"]) == list(FRAME_KEYS)
    assert on_disk["frame_specs"]["img"] == {"shape": [1, 2, 64, 128, 3],
                                             "dtype": "float32"}
    assert on_disk["ops"] == sorted(
        op for op, k in library.OPS.items() if k in "ABCD")
    # every stored weight is read by a program, and each is stored once
    weights = torch.load(os.path.join(out, "weights.pt"), weights_only=True)
    names = [n for p in on_disk["programs"].values() for n in p["weights"]]
    assert set(names) == set(weights)
    assert on_disk["weights"]["count"] == len(weights)
    assert len({t.untyped_storage().data_ptr()
                for t in weights.values()}) == len(weights)
    # the kernels' packs replace the blocks' and the patch embedding's
    # parameters: none of those is saved
    backbone = set(on_disk["programs"]["backbone_first"]["weights"])
    assert "img_backbone.blocks.0:block.wqkv" in backbone
    assert "img_backbone.patch_embed.proj:patchify.0" in backbone
    assert not any(n.startswith("img_backbone.blocks.") and ":" not in n
                   for n in backbone)
    assert "img_backbone.patch_embed.proj.weight" not in backbone
    # the steady program skips the selectors' first-frame score MLP
    assert set(on_disk["programs"]["backbone_steady"]["weights"]) < backbone
    # the programs hold their graphs and a few small constants (RoPE
    # tables, normalisation vectors), no example inputs and no weight
    for name in on_disk["programs"]:
        prog = torch.export.load(os.path.join(out, f"{name}.pt2"))
        assert prog.example_inputs is None
        assert sum(c.numel() * c.element_size()
                   for c in prog.constants.values()) < 1e-2 * sum(
            t.numel() * t.element_size() for t in weights.values())
    memory = torch.load(os.path.join(out, "memory.pt"), weights_only=True)
    assert list(memory) == list(BANK)
    assert all(not t.any() for t in memory.values())


def test_streaming_parity_exact(artifact):
    """3 streaming frames (first-frame program, then steady): outputs and
    the threaded memory bank equal eager_infer_fn's bit for bit (same ops,
    same device, same weights)."""
    _, _, model, out, _ = artifact
    det = load_detector(out, device="cpu")
    ref = td.eager_infer_fn(model)
    s_exp, s_ref = det.init_state(), td.init_state(1, model.cfg, "cpu")
    for i, frame in enumerate(_frames(5)):
        s_exp, d_exp = det(s_exp, frame)
        s_ref, d_ref = ref(s_ref, frame)
        _equal(d_exp, s_exp, d_ref, s_ref, f"frame {i}")


def test_load_without_model_modules(artifact, monkeypatch):
    """Loading and serving read the artifact only: the model's forward
    functions are never called."""
    _, _, model, out, _ = artifact
    calls = []
    for name in ("extract_img_feat", "head_step"):
        fn = getattr(td, name)
        monkeypatch.setattr(td, name, lambda *a, _f=fn, **k:
                            calls.append(1) or _f(*a, **k))
    det = ExportedDetector(out, device="cpu")
    state, boxes = det(det.init_state(), _frames(7)[0])
    assert calls == [], "serving path ran the Python model"
    assert tuple(boxes.bboxes.shape) == (1, model.cfg.head.max_decode, 9)


def test_fresh_process_loads_without_model_modules(artifact, tmp_path):
    """A fresh interpreter loads the artifact and runs a first and a steady
    frame without importing any toc3d_tpu_torch.models module."""
    _, _, _, out, _ = artifact
    frames = _frames(9, t_total=2)
    np.savez(tmp_path / "frames.npz", **{f"{t}_{k}": v for t, f in
                                         enumerate(frames)
                                         for k, v in f.items()})
    code = (
        "import sys, numpy as np\n"
        "from toc3d_tpu_torch.runtime.export import load_detector\n"
        f"det = load_detector({out!r}, device='cpu')\n"
        f"z = np.load({str(tmp_path / 'frames.npz')!r})\n"
        "state = det.init_state()\n"
        "for t in range(2):\n"
        "    f = {k.split('_', 1)[1]: z[k] for k in z.files\n"
        "         if k.startswith(f'{t}_')}\n"
        "    state, boxes = det(state, f)\n"
        "assert boxes.scores.isfinite().all()\n"
        "mods = [m for m in sys.modules\n"
        "        if m.startswith('toc3d_tpu_torch.models')]\n"
        "assert not mods, mods\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("quant,static", [(("head",), False),
                                          (("backbone", "head"), False),
                                          (("backbone", "head"), True)])
def test_int8_uint8_img_export_selfcheck(tmp_path, quant, static):
    """The serving variants: the int8 head decoder (H8), with the int8
    backbone blocks (B8, C8) dynamic or with calibrated static scales, on
    raw uint8 frames normalized inside the backbone program; bit for bit
    against eager_infer_fn on the same quantized model."""
    jcfg, tcfg = _configs(quant)
    sd = build_reference_state_dict(jcfg, np.random.RandomState(4))
    model = td.build_detector(tcfg, device="cpu", state_dict=sd)
    frames = [td.frame_to_device(f, "cpu") for f in _frames(11, uint8=True)]
    if static:
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(model, frames[:2]))
    out = str(tmp_path / "int8")
    manifest = export_detector(model, out, batch_size=1, num_views=2,
                               img_dtype=torch.uint8)
    assert manifest["quant"] == {
        "backbone": "int8" if "backbone" in quant else "none",
        "head": "int8"}
    assert manifest["frame_specs"]["img"]["dtype"] == "uint8"
    assert "toc3d::int8_linear" in manifest["ops"]
    assert ("toc3d::fused_compressed_block_int8" in manifest["ops"]) == (
        "backbone" in quant)
    names = manifest["programs"]["backbone_first"]["weights"]
    assert ("img_backbone.blocks.2:block_int8.act" in names) == static
    det = load_detector(out, device="cpu")
    ref = td.eager_infer_fn(model)
    s_exp, s_ref = det.init_state(), td.init_state(1, model.cfg, "cpu")
    for i, frame in enumerate(frames):
        s_exp, d_exp = det(s_exp, frame)
        s_ref, d_ref = ref(s_ref, frame)
        _equal(d_exp, s_exp, d_ref, s_ref, f"frame {i}")


def test_gumbel_not_exportable(tmp_path):
    _, tcfg = _configs()
    tcfg = replace(tcfg, backbone=replace(tcfg.backbone, eval_mask="gumbel"))
    model = td.build_detector(tcfg, device="cpu")
    with pytest.raises(ValueError, match="gumbel"):
        export_detector(model, str(tmp_path / "x"), num_views=2)


def test_exported_matches_jax_make_infer_fn(artifact):
    """The loaded artifact against the JAX package's make_infer_fn on the
    same reference state dict: 3 frames, scores, boxes and the bank at
    1e-3, labels and validity equal, ranks of near-tied scores (1e-6) in
    either order (tests/test_torch_presets.py's comparison: random weights
    score queries alike, and at frame 2 here ranks 5 and 6 differ by
    6e-8)."""
    jcfg, sd, _, out, _ = artifact
    params = convert_detector_checkpoint(sd, jcfg)
    det = load_detector(out, device="cpu")
    jinfer = jax_make_infer_fn(jcfg)
    jstate, tstate = jax_init_state(1, jcfg), det.init_state()
    for t, frame in enumerate(_frames(13)):
        jstate, jdet = jinfer(params, jstate,
                              {k: jnp.asarray(v) for k, v in frame.items()})
        tstate, tdet = det(tstate, frame)
        compare_with_ties(t, tdet, jdet, tstate, jstate)


# ---------------------------------------------------------------------------
# the toc3d ops: CPU implementation against the fake one
# ---------------------------------------------------------------------------

def _block_args(int8, compressed):
    """A small block (C 64, 2 heads, hidden 170, ws 4 on a 8 x 8 map) as
    the op's arguments."""
    torch.manual_seed(0)
    blk = Block(EVAViTConfig(embed_dim=64, num_heads=2, mlp_ratio=170 / 64))
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape) * 0.05)
    x = torch.randn(2, 8, 8, 64)
    cos, sin = (torch.from_numpy(t) for t in build_rope_table(16, 4, 4))
    pack = vit_block.pack_block_weights_int8 if int8 else \
        vit_block.pack_block_weights
    wts = pack(blk, 2, torch.float32)
    args = [x, vit_block._op_weights(wts), wts.hidden]
    if int8:
        args.append(None)
    if compressed:
        plan = vit_block.compress_plan(torch.randn(2, 64), 2, 8, 8, 4, 0.5,
                                       True, True)
        args += [plan.slow_idx, plan.fast_idx, plan.fast_score,
                 plan.has_rep]
    return args + [2, 4, cos, sin]


def _op_cases():
    q = torch.randn(1, 8, 64)
    kv = torch.randn(1, 12, 64)
    p = quantize_linear(torch.randn(16, 32), torch.randn(16))
    return {
        "toc3d::patchify_matmul": lambda: [
            torch.randn(1, 32, 32, 3), torch.randn(8, 768), torch.randn(8),
            16],
        "toc3d::fused_full_block": lambda: _block_args(False, False),
        "toc3d::fused_compressed_block": lambda: _block_args(False, True),
        "toc3d::flash_attention_core": lambda: [q, kv, kv.flip(1), 2],
        "toc3d::fused_full_block_int8": lambda: _block_args(True, False),
        "toc3d::fused_compressed_block_int8": lambda: _block_args(True,
                                                                  True),
        "toc3d::int8_linear": lambda: [torch.randn(2, 5, 32), p.w, p.scale,
                                       p.bias],
    }


@pytest.mark.parametrize("name", list(library.OPS))
def test_opcheck(name):
    """Schema, fake-tensor metadata (shape, dtype, strides) and the
    dispatch tests of each toc3d op's CPU implementation."""
    op = getattr(torch.ops.toc3d, name.split("::")[1]).default
    torch.library.opcheck(op, _op_cases()[name]())


def test_pack_taken_as_it_stands_under_export():
    """Under torch.export param_key reads no storage and cached_pack
    returns the pack built before the trace; a pack not built before the
    trace raises instead of being built from fake tensors."""
    blk = Block(EVAViTConfig(embed_dim=64, num_heads=2, mlp_ratio=170 / 64))
    cos, sin = (torch.from_numpy(t) for t in build_rope_table(16, 4, 4))

    class Root(torch.nn.Module):
        def forward(self, x):
            return vit_block.fused_full_block(blk, x, 2, 4, (cos, sin))
    x = torch.randn(1, 8, 8, 64)
    with pytest.raises(RuntimeError, match="not built before the export"):
        torch.export.export(Root(), (x,), strict=False)
    wts = vit_block.pack_block_weights(blk, 2, torch.float32)
    prog = torch.export.export(Root(), (x,), strict=False)
    assert torch.equal(prog.module()(x), vit_block.full_block_plain(
        wts, x, 2, 4, (cos, sin)))
    assert vit_block.pack_block_weights(blk, 2, torch.float32) is wts


def test_export_cli_selfcheck(tmp_path, capsys):
    out = str(tmp_path / "cli")
    rc = export_cli.main(["--config", "tiny", "--device", "cpu", "--views",
                          "2", "--out", out, "--selfcheck"])
    text = capsys.readouterr().out
    assert rc == 0, text
    line = json.loads(next(ln for ln in text.splitlines()
                           if ln.startswith("{")))
    assert line["export_s"] > 0
    assert set(line["artifact_bytes"]) == set(os.listdir(out))
    assert "# selfcheck OK (bit-identical)" in text


# ---------------------------------------------------------------------------
# the served detector's CUDA path, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(artifact):
    return load_detector(artifact[3], device="cpu")


def test_call_is_eager_on_cpu(served):
    """On the CPU there is nothing to capture: a call is the eager run."""
    det = served
    s_call, s_eager = det.init_state(), det.init_state()
    for i, frame in enumerate(_frames(17)):
        s_call, d_call = det(s_call, frame)
        s_eager, d_eager = det.eager(s_eager, frame)
        _equal(d_call, s_call, d_eager, s_eager, f"frame {i}")


@pytest.mark.parametrize("key,bad", [
    ("img", lambda v: v[:, :1]),                     # one view of two
    ("img", lambda v: v.astype(np.float64)),
    ("img", lambda v: v.astype(np.uint8)),
    ("intrinsics", lambda v: v[..., :3, :3]),
    ("timestamp", lambda v: v.astype(np.float16)),
    ("prev_exists", lambda v: np.concatenate([v, v])),   # batch 2 of 1
])
def test_frame_of_another_shape_or_dtype_raises(served, key, bad):
    """A replay runs none of the loaded programs' own input checks: the
    host holds each frame to the manifest's shapes and dtypes first, on
    the eager run and on the replayed one."""
    det = served
    frame = dict(_frames(19, t_total=1)[0])
    frame[key] = bad(frame[key])
    with pytest.raises(ValueError, match=key):
        det(det.init_state(), frame)
    with pytest.raises(ValueError, match=key):
        det._replay(det.init_state(), frame)


def test_replayed_programs_are_captured_once_and_kept(artifact,
                                                      cuda_standins):
    """The CUDA path with CPU stand-ins for the graph API (a capture runs
    its function, a replay does nothing): over a stream with a scene reset
    each program (backbone_first, backbone_steady, then the head's
    head+decode) is captured once, at its first use, into the buffers of
    the first frame's layout; the first frame's result (its programs' eager
    first runs) is eager's. A frame laid out with other strides drops the
    graphs and captures anew on new buffers."""
    _, _, _, out, _ = artifact
    det = load_detector(out, device="cpu")
    frames = _frames(23, t_total=5)
    frames[3]["prev_exists"][:] = 0.0
    state, seen = det.init_state(), {}
    for t, frame in enumerate(frames):
        state, boxes = det._replay(state, frame)
        if t == 0:
            s_ref, d_ref = det.eager(det.init_state(), frame)
            _equal(boxes, state, d_ref, s_ref, "frame 0")
            buffers = dict(det.runner.frame)
        for name, prog in det.runner.programs.items():
            assert seen.setdefault(name, prog) is prog, (t, name)
        assert all(det.runner.frame[k] is v for k, v in buffers.items())
    assert sorted(seen) == ["backbone_first", "backbone_steady",
                            "head+decode"]
    f = dict(frames[4])
    f["img"] = torch.from_numpy(f["img"]).transpose(2, 3).contiguous() \
        .transpose(2, 3)
    det._replay(state, f)
    assert det.runner.frame["img"] is not buffers["img"]
    assert det.runner.frame["img"].stride() == f["img"].stride()
    assert all(det.runner.programs[n] is not seen[n]
               for n in det.runner.programs)


def test_programs_hold_no_host_sync(served):
    """A graph capture fails on a host synchronisation: no loaded program
    reads a device value on the host (.item(), a data-dependent shape)."""
    syncs = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
             "aten.masked_select", "aten.unique", "aten._unique2",
             "aten.unique_consecutive", "aten.unique_dim"}
    assert len(served._programs) == 3
    for name, (prog, _) in served._programs.items():
        called = {str(n.target).rsplit(".", 1)[0] for n in prog.graph.nodes
                  if n.op == "call_function"}
        assert "toc3d.flash_attention_core" in called or "backbone" in name
        assert not called & syncs, (name, called & syncs)


def test_capture_and_export_import_no_model_module():
    """runtime/capture.py and runtime/export.py (and the counters a capture
    reads) load in a fresh interpreter without any toc3d_tpu_torch.models
    module."""
    code = (
        "import sys\n"
        "from toc3d_tpu_torch.runtime import capture, export\n"
        "from toc3d_tpu_torch.ops.cuda import counted_wrappers, library\n"
        "assert list(counted_wrappers()) == ['A', 'B', 'C', 'D', 'B8', "
        "'C8', 'H8', 'G', 'G8', 'LN', 'AU', 'W1', 'W2', 'conv', 'qkv']\n"
        "mods = [m for m in sys.modules\n"
        "        if m.startswith('toc3d_tpu_torch.models')]\n"
        "assert not mods, mods\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
