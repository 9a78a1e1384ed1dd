"""The V2-99 configuration (perfbench/encoders/vovnet.py and its cell): a
tiny VoVNet configuration runs correct through run_cell on the CPU as new
files only, the full configuration's weight layout and operation count are
pinned (digests recorded when the cell was added), the count restates the
backbone's 328,548 multiply-adds a pixel, conv_roofline counts the
convolutions its kernels run, and the reference imports neither JAX nor the
program."""
from __future__ import annotations

import dataclasses
import json

from perfbench import counting
from perfbench.encoders import vovnet
from perfbench.metrics import conv_roofline
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_encoders import spec_digest
from perfbench.tests.test_perfbench_harness import FORBIDDEN, _python

NAME = "stream_petr_vov_flash_800_bs2_seq_24e"
CELL = "streampetr_v299_800.stream_b1_800x320"
SPEC_DIGEST = (
    "f12ddf74bffbf2c6367f5406cd6e011f2da32426de5501abe5ab7b9c97504edf")
MODEL_FLOPS = 1098868826112.0
# VoVNet-99-eSE's convolutions, stem to stage 5, per input pixel at the
# strides 2, 4, 8, 16, 32 (the eSE gates aside: C x C a map)
MACS_A_PIXEL = 328548


def _cfg():
    return json.loads((REPO / "perfbench/configs" / f"{NAME}.json")
                      .read_text())


def test_layout_and_operations_of_the_cell_are_pinned():
    cfg = _cfg()
    assert spec_digest(cfg) == SPEC_DIGEST
    assert counting.model_flops(cfg, 6, 1) == MODEL_FLOPS


def test_flops_restate_the_multiply_adds_a_pixel():
    cfg = _cfg()
    pixels = 6 * 320 * 800
    neck = 2.0 * 6 * (20 * 50 * (768 * 256 + 256 * 256 * 9)
                      + 10 * 25 * 1024 * 256)
    ese = 2.0 * 6 * (256 ** 2 + 512 ** 2 + 768 ** 2 + 1024 ** 2)
    assert vovnet.flops(cfg, 6, 1) == 2 * MACS_A_PIXEL * pixels + neck + ese
    shapes = vovnet.conv_shapes(cfg, 6, 1)
    assert len(shapes) == 106
    # stage 4 at 20 x 50 holds ~42% of the operations
    s4 = sum(2.0 * m * n * k for lab, m, n, k, _ in shapes
             if lab.startswith("stage4"))
    assert 0.40 < s4 / vovnet.flops(cfg, 6, 1) < 0.44


def test_conv_roofline_counts_the_convolutions_its_kernels_run():
    """The match catches cuDNN's convolution kernels ('fprop') and the
    cuBLASLt GEMMs with the fused bias and ReLU ('relubias'): every
    conv-BN-ReLU and the neck's 3x3; the eSE gates and the laterals run on
    the plain GEMMs that the head shares and are left out."""
    cfg = _cfg()
    got = conv_roofline.launches(cfg, 6, 1)
    labels = [lab for lab, _, _ in got]
    assert len(got) == 100 and "neck.fpn.0" in labels
    assert not any(".ese." in x or "lateral" in x for x in labels)
    assert conv_roofline.matched(
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc")
    assert conv_roofline.matched(
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_relubias_TNN")
    for head in ("nvjet_tst_128x96_64x7_1x2_h_bz_bias_TNT",
                 "nvjet_tst_128x96_64x7_1x2_h_bz_TNT",
                 "void flash::flash_partial_kernel<32>"):
        assert not conv_roofline.matched(head)
    bound = sum(counting.least_time(f, b) for _, f, b in got)
    assert 1.0e-3 < bound < 1.2e-3        # s a frame, mostly operations


def test_a_tiny_vovnet_cell_is_correct_as_new_files(tiny_checkout):
    """The tiny_vov preset as a configuration with encoder 'vovnet' and a
    cell on stream_b1 at the tiny limits: a traced CPU run is correct and
    reads the VoVNet spans; no harness file is edited."""
    from toc3d_tpu_torch.configs import get_config
    from perfbench.program import _plain
    root, bench = tiny_checkout
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*.py")}
    cfg = {"name": "tiny_vov", "preset": "tiny_vov", "views": 6,
           "reduced": [], "source": "tests", "why": "tests", "assumed": {},
           "encoder": "vovnet"}
    cfg.update(_plain(dataclasses.asdict(get_config("tiny_vov"))))
    (root / "perfbench/configs/tiny_vov.json").write_text(json.dumps(cfg))
    limits = {"emb_med": 1e-4, "size_rms": 1e-4, "score_gap": 1e-4}
    (root / "perfbench/cells/tiny_vov.stream_b1.json").write_text(
        json.dumps({"limits": limits}))
    bench["configs"].append({"name": "tiny_vov", "source": "tests",
                             "file": "perfbench/configs/tiny_vov.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny_vov.stream_b1",
                               "config": "tiny_vov", "traffic": "stream_b1",
                               "chips": 1, "why": "tests"})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny_vov.stream_b1")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(
        "import json; from pathlib import Path; "
        "from perfbench.cell import run_cell; "
        "b = json.loads(Path('BENCHMARK.json').read_text()); "
        "r, _ = run_cell(b, 'tiny_vov.stream_b1', 2 ** 34 + 9, 1.0, True, "
        "'cpu', Path('.')); r.pop('_judged'); print(json.dumps(r))", root)
    res = json.loads(out)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(limits)
    m = res["metrics"]
    for name in ("vov_hires_ms", "vov_lowres_ms", "neck_ms",
                 "backbone_neck_ms", "mfu"):
        assert m[name]["value"] > 0, name
    assert m["vov_hires_ms"]["value"] + m["vov_lowres_ms"]["value"] + \
        m["neck_ms"]["value"] < m["backbone_neck_ms"]["value"]
    assert "selector_ms" not in m and "conv_roofline" not in m
    assert before == {p: p.read_bytes() for p in before}


def test_the_vovnet_reference_imports_neither_jax_nor_the_program():
    out = _python(
        "import sys, perfbench.encoders.vovnet, perfbench.metrics."
        "conv_roofline; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))", REPO)
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"toc3d_tpu_torch"})
