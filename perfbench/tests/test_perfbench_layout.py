"""The benchmark's files are found by name, and its counts reproduce the
kernel table's bounds."""
from __future__ import annotations

import json

import pytest

from perfbench import counting, encoders, metrics, rooflines
from perfbench.encoders import eva_vit
from perfbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
PB = REPO / "perfbench"


def _stems(sub, suffix):
    return {p.stem for p in (PB / sub).glob(f"*{suffix}")
            if not p.stem.startswith("_")}


def test_every_file_is_found_by_name():
    assert _stems("configs", ".json") == {
        c["file"].split("/")[-1][:-5] for c in BENCH["configs"]}
    assert {c["name"] for c in BENCH["configs"]} == {
        c["file"].split("/")[-1][:-5] for c in BENCH["configs"]}
    assert _stems("encoders", ".py") == {
        json.loads((REPO / c["file"]).read_text())["encoder"]
        for c in BENCH["configs"]}
    assert _stems("workloads", ".json") == {
        w["traffic"] for w in BENCH["workloads"]}
    assert _stems("cells", ".json") == {w["name"] for w in BENCH["workloads"]}
    assert _stems("metrics", ".py") == {m["name"] for m in BENCH["per_layer"]}
    assert _stems("end_to_end", ".py") == {
        m["name"] for m in BENCH["end_to_end"]}
    used = {"gemm_bf16", "window_attention"}
    assert _stems("rooflines", ".py") == used
    for name in used:
        mod = rooflines.load(name)
        assert mod.MATCH and callable(mod.launches)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_module_names_its_layer_and_moves(m):
    mod = metrics.load(m["name"])
    assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("path", sorted((PB / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_file_matches_the_program_preset(path):
    from perfbench import program
    cfg = json.loads(path.read_text())
    assert cfg["name"] == path.stem and cfg["reduced"] == []
    # the encoder is the file's own key, found as a module by its name
    assert "encoder" in program.META_KEYS
    mod = encoders.load(cfg)
    assert mod.__name__ == "perfbench.encoders." + cfg["encoder"]
    for c in BENCH["configs"]:
        if c["name"] == cfg["name"]:
            assert (c["source"], c["reduced"]) == (cfg["source"], [])
    program.program_config(cfg)       # raises on any differing key
    bad = dict(cfg, backbone=dict(cfg["backbone"], embed_dim=768))
    with pytest.raises(ValueError, match="embed_dim"):
        program.program_config(bad)


@pytest.mark.parametrize("label,m,n,k,ms", [
    ("QKV", 30001, 3072, 1024, 0.1908), ("O", 30001, 1024, 1024, 0.06362),
    ("gate", 30001, 5472, 1024, 0.3400), ("w3", 30001, 1024, 2736, 0.1700),
    ("QKV", 21504, 3072, 1024, 0.1368), ("gate", 21504, 5472, 1024, 0.2437)])
def test_gemm_counts_reproduce_the_kernel_table(label, m, n, k, ms):
    got = counting.least_time(counting.mm(m, n, k),
                              2.0 * (m * k + k * n + m * n)) * 1e3
    assert got == pytest.approx(ms, rel=5e-4)


def _cfg(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def test_block_gemms_at_30001_rows_are_the_table_shapes():
    # the SwiGLU's 2730 wide hidden layer, which the program pads to 2736
    shapes = eva_vit.block_gemms(_cfg("ToC3D_faster_1600"), 30001)
    assert [s[1:] for s in shapes] == [(30001, 3072, 1024),
                                       (30001, 1024, 1024),
                                       (30001, 5460, 1024),
                                       (30001, 1024, 2730)]


def test_window_attention_counts_reproduce_the_kernel_table():
    # the table counted q, k, v as the f32 QKV product the kernel reads:
    # B at ws 16 / 20 0.1284 ms, C at ws 16 ratio .5 0.09206 ms
    launches = rooflines.window_attention.launches(
        _cfg("ToC3D_faster_1600"), 6, 1, qkv_bytes=4)
    ms = [counting.least_time(f, b) * 1e3 for _, f, b in launches]
    assert ms[0] == pytest.approx(0.1284, rel=5e-4)      # block 0, ws 16
    assert ms[2] == pytest.approx(0.1284, rel=5e-4)      # block 2, ws 20
    assert ms[6] == pytest.approx(0.09206, rel=1e-3)     # block 6, C .5


def test_block_schedule_of_the_two_configurations():
    toc = eva_vit.blocks(_cfg("ToC3D_faster_1600"), 6, 1)
    sp = eva_vit.blocks(_cfg("stream_petr_eva_vit_l_1600"), 6, 1)
    assert [b["kind"] for b in toc] == ["full"] * 6 + ["compressed"] * 18
    assert all(b["kind"] == "full" and b["rows"] == 30000 for b in sp)
    # ws 16 windows: 168 at k 127 + 1; ws 20: 90 at k 200 + 1
    assert (toc[6]["windows"], toc[6]["per_window"]) == (168, 128)
    assert (toc[8]["windows"], toc[8]["per_window"]) == (90, 201)
    # ratio .4 and .3 after blocks 12 and 18
    assert toc[12]["per_window"] == 103 and toc[18]["per_window"] == 77


def test_model_operations_are_counted_from_the_configuration():
    toc = counting.model_flops(_cfg("ToC3D_faster_1600"), 6, 1)
    sp = counting.model_flops(_cfg("stream_petr_eva_vit_l_1600"), 6, 1)
    # G alone is 24 x 756 GFLOP on 30000 rows in the plain backbone
    g = 24 * sum(counting.mm(*s[1:]) for s in eva_vit.block_gemms(
        _cfg("stream_petr_eva_vit_l_1600"), 30000))
    assert 18.1e12 < g < sp < 20.5e12
    assert 11e12 < toc < 14e12
