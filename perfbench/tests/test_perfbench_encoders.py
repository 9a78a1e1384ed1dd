"""The image encoder as a configuration's own files (perfbench/encoders):
the shared harness gives the same weights, reference outputs, layouts and
operation counts as before the encoder was split out of it (digests
recorded on that harness, held exactly), a configuration brings a new
encoder as new files only, and an unknown encoder is refused by name."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from perfbench import counting, encoders, weights
from perfbench.reference import model as ref
from perfbench.tests.conftest import REPO, TINY_LIMITS, tiny_config_file
from perfbench.tests.test_perfbench_harness import _python
from perfbench.traffic import Stream, load

CELL_CONFIGS = ("ToC3D_faster_1600", "stream_petr_eva_vit_l_1600")

# sha256 digests and counts of the harness as it was before the encoder
# had files of its own (CPU, float32, one thread)
STATE_DICT_TINY_SEED0 = (
    "b92e345caac621fa69565da765f4f1f619d188a62935411d13cc3a4d21781ed8")
FRAMES_TINY = {
    "scene start":
        "6559016c7fe1df7bf8422c34395acb507646085582d03da55e1eff03a893f0d1",
    "mid-scene":
        "e9f8a98f48f1b247f43318e83548cb949f1da5c64933756696c1af276d3ba968",
}
SPEC = {
    "ToC3D_faster_1600":
        "d44d0908ad484185ec4605c7a0e115e426b0a2bf026c4a3d19b0861a5892f962",
    "stream_petr_eva_vit_l_1600":
        "9e2a17a1246a5e311e4952db7d8c053407de7fb5b195a020562b18ff45f1c54d"}
MODEL_FLOPS = {"ToC3D_faster_1600": 12738127048704.0,
               "stream_petr_eva_vit_l_1600": 19401956401152.0}


def _cfg(name):
    return json.loads((REPO / "perfbench/configs" / f"{name}.json")
                      .read_text())


def _digest(items) -> str:
    """sha256 over (name, dtype, shape, bytes) of named CPU tensors, in
    order."""
    h = hashlib.sha256()
    for name, t in items:
        t = t.detach().contiguous().cpu()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def spec_digest(cfg) -> str:
    return hashlib.sha256(json.dumps(
        [[n, list(s), k] for n, s, k in weights._spec(cfg)]).encode()
    ).hexdigest()


def frame_digests(seed=0):
    """{kind: digest} of the reference's outputs and bank at tiny for a
    scene start from an empty bank and the mid-scene frame after it."""
    cfg = tiny_config_file()
    sd = weights.make_state_dict(cfg, seed, "cpu")
    stream = Stream(load("stream_b1", REPO), cfg, seed, pin=False)
    bank = ref.empty_bank(cfg, 1, "cpu")
    out = {}
    for i, kind in enumerate(("scene start", "mid-scene")):
        res, bank = ref.frame_forward(sd, cfg, stream.frame(i), bank)
        out[kind] = _digest(sorted(res.items()) + sorted(bank.items()))
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_state_dict_at_tiny_is_the_parent_s(one_thread):
    sd = weights.make_state_dict(tiny_config_file(), 0, "cpu")
    assert _digest(sd.items()) == STATE_DICT_TINY_SEED0


def test_reference_frames_at_tiny_are_the_parent_s(one_thread):
    assert frame_digests() == FRAMES_TINY


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_weight_layout_of_the_cells_is_the_parent_s(name):
    assert spec_digest(_cfg(name)) == SPEC[name]


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_model_flops_of_the_cells_are_the_parent_s(name):
    assert counting.model_flops(_cfg(name), 6, 1) == MODEL_FLOPS[name]


def test_a_new_encoder_is_new_files_only(tiny_checkout):
    """A configuration that names an encoder of its own (here a byte copy
    of eva_vit.py under another name) goes in as an encoder module, a
    configuration file, a limits file and entries of BENCHMARK.json; its
    run is correct, reads its own module and edits no file of the
    harness."""
    root, bench = tiny_checkout
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*.py")}
    shutil.copyfile(root / "perfbench/encoders/eva_vit.py",
                    root / "perfbench/encoders/eva_vit_copy.py")
    (root / "perfbench/configs/tiny_copy.json").write_text(json.dumps(
        tiny_config_file(name="tiny_copy", encoder="eva_vit_copy")))
    (root / "perfbench/cells/tiny_copy.stream_b1.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    bench["configs"].append({"name": "tiny_copy", "source": "tests",
                             "file": "perfbench/configs/tiny_copy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_copy.stream_b1",
                               "config": "tiny_copy", "traffic": "stream_b1",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(
        "import json, sys; from pathlib import Path; "
        "from perfbench.cell import run_cell; "
        "b = json.loads(Path('BENCHMARK.json').read_text()); "
        "r, _ = run_cell(b, 'tiny_copy.stream_b1', 2 ** 34 + 5, 1.0, True, "
        "'cpu', Path('.')); r.pop('_judged'); "
        "r['encoders'] = sorted(m for m in sys.modules "
        "if m.startswith('perfbench.encoders.')); print(json.dumps(r))", root)
    res = json.loads(out)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS)
    assert res["encoders"] == ["perfbench.encoders.eva_vit_copy"]
    # the shared per-layer metrics read the new cell with no list to edit
    assert {"mfu", "inputs_ms", "decoder_ms", "head_glue_ms",
            "backbone_neck_ms", "head_decode_ms"} <= set(res["metrics"])
    assert before == {p: p.read_bytes() for p in before}


@pytest.mark.parametrize("encoder", ["no_such_encoder", "eva_vit.x", None])
def test_an_unknown_encoder_is_refused_by_its_key(encoder):
    cfg = tiny_config_file(encoder=encoder)
    if encoder is None:
        del cfg["encoder"]
    for use in (encoders.load, weights._spec,
                lambda c: counting.model_flops(c, 6, 1),
                lambda c: ref.frame_forward({}, c, {"img": torch.zeros(
                    1, 6, 64, 128, 3, dtype=torch.uint8)}, {})):
        with pytest.raises(ValueError, match="'tiny', key 'encoder'"):
            use(cfg)
