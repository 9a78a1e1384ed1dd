"""StreamPETR V2-99 on the port's normal path, on the CPU: the two-level
CPFPN against its equations (and the one-level neck unchanged), the
``tiny_vov`` preset streamed through ``make_infer_fn`` against the
benchmark's plain reference (perfbench/encoders/vovnet.py and
perfbench/reference/model.py, f32, no code of the port), the preset's
weight names against the benchmark's layout, and ``precast_backbone_``'s
packs (bf16, channels-last, BatchNorm folded). The card's checks (captured
against eager, 106 convolution launches a frame, no weight cast and no
layout transpose in a frame) are in tests/test_torch_cuda.py."""
import dataclasses
import math
import re
from dataclasses import replace

import pytest
import torch
import torch.nn.functional as F

from perfbench import check, weights
from perfbench.encoders import vovnet as ref_vovnet
from perfbench.program import _plain
from perfbench.reference import model as ref
from perfbench.tests.conftest import REPO
from perfbench.traffic import Stream, load
from toc3d_tpu_torch.configs import PORT_PRESETS, PRESETS, get_config
from toc3d_tpu_torch.layers import conv2d
from toc3d_tpu_torch.models import detector as td
from toc3d_tpu_torch.models.neck import CPFPN, CPFPNConfig, cpfpn_forward
from toc3d_tpu_torch.models.vovnet import VoVNetConfig, vovnet_forward
from toc3d_tpu_torch.ops.cuda import PACK_CACHE
from toc3d_tpu_torch.ops.cuda.conv import fold_conv
from toc3d_tpu_torch.runtime.timer import StageTimer

PRESET = "stream_petr_vov_flash_800_bs2_seq_24e"
# f32 on both sides: the port's channel-last convolutions with the
# BatchNorms folded in, against the reference's NCHW convolutions with the
# norms applied after; they differ only in rounding order, which reads
# ~1e-6 through the 100 convolutions and the head at tiny
F32_TOL = 1e-4


def _config_file(name):
    """The program's preset ``name`` as a benchmark configuration file."""
    cfg = {"name": name, "preset": name, "views": 6, "reduced": [],
           "source": "the program's preset", "why": "tests",
           "assumed": {}, "encoder": "vovnet"}
    cfg.update(_plain(dataclasses.asdict(get_config(name))))
    return cfg


def _model(name="tiny_vov", seed=3, **kw):
    cfg_file = _config_file(name)
    sd = weights.make_state_dict(cfg_file, seed, "cpu")
    cfg = replace(get_config(name), **kw)
    return cfg_file, sd, td.build_detector(cfg, device="cpu", state_dict=sd)


# ---------------------------------------------------------------------------
# (a) the neck
# ---------------------------------------------------------------------------

def _neck(cfg, seed):
    neck = td.build_module(lambda: CPFPN(cfg), "cpu", seed=seed).eval()
    with torch.no_grad():
        for p in neck.parameters():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(
                seed + p.numel()))
    return neck


def test_two_level_cpfpn_matches_its_equations():
    """lat_i = conv1x1_i(x_i) + b; lat_0 += nearest(lat_1, size of lat_0);
    out_0 = conv3x3(lat_0) + b; out_1 = lat_1 (no fpn convolution on
    level 1), in plain NCHW f32, at odd sizes (upsampling to 7 x 11 from
    4 x 6)."""
    cfg = CPFPNConfig(in_channels=(24, 40), out_channels=16, num_outs=2)
    neck = _neck(cfg, 5)
    g = torch.Generator().manual_seed(6)
    x0 = torch.randn(2, 7, 11, 24, generator=g)
    x1 = torch.randn(2, 4, 6, 40, generator=g)
    with torch.no_grad():
        out0, out1 = cpfpn_forward(neck, [x0, x1], cfg)
        lat = [F.conv2d(x.permute(0, 3, 1, 2), m.conv.weight, m.conv.bias)
               for x, m in zip((x0, x1), neck.lateral_convs)]
        up = F.interpolate(lat[1], size=(7, 11), mode="nearest")
        want0 = F.conv2d(lat[0] + up, neck.fpn_convs[0].conv.weight,
                         neck.fpn_convs[0].conv.bias, padding=1)
    torch.testing.assert_close(out0, want0.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out1, lat[1].permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)
    assert sorted(k for k in neck.state_dict()) == [
        "fpn_convs.0.conv.bias", "fpn_convs.0.conv.weight",
        "lateral_convs.0.conv.bias", "lateral_convs.0.conv.weight",
        "lateral_convs.1.conv.bias", "lateral_convs.1.conv.weight"]
    with pytest.raises(ValueError, match="input levels"):
        cpfpn_forward(neck, [x0], cfg)


def test_one_level_cpfpn_is_unchanged():
    """The ViT configurations' neck, on its packs, computes what the
    per-call casts computed before (conv3x3(conv1x1(x)), then level 1 the
    subsampled level 0), bit for bit in f32; its training form is that
    per-call code."""
    cfg = CPFPNConfig(in_channels=(32,), out_channels=16, num_outs=2)
    neck = _neck(cfg, 7)
    x = torch.randn(2, 8, 12, 32, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        before = conv2d(neck.fpn_convs[0].conv,
                        conv2d(neck.lateral_convs[0].conv, x))
        packed = cpfpn_forward(neck, x, cfg)
        trained = cpfpn_forward(neck, x, cfg, train=True)
    for outs in (packed, trained):
        assert torch.equal(outs[0], before)
        assert torch.equal(outs[1], before[:, ::2, ::2, :])


# ---------------------------------------------------------------------------
# (b) the streamed preset against the plain reference
# ---------------------------------------------------------------------------

def test_tiny_vov_streams_as_the_plain_reference():
    """Three frames of ``tiny_vov`` (a scene start, two mid-scene) through
    make_infer_fn (eager on the CPU) against the benchmark's plain
    reference on the same seeded weights and frames; the reference starts
    each frame from the bank the port carried into it, as perfbench/check
    does. Boxes, scores (as logits) and the bank at F32_TOL."""
    cfg_file, sd, model = _model()
    stream = Stream(load("stream_b1", REPO), cfg_file, 11, pin=False)
    infer = td.make_infer_fn(model)
    state = td.init_state(1, model.cfg, device="cpu")
    topk = cfg_file["head"]["topk_proposals"]
    bank_of = lambda s: dict(zip(ref.BANK_KEYS, s.memory))
    host = lambda d: {k: v.double().numpy() for k, v in d.items()}
    for i in range(3):
        frame = stream.frame(i)
        bank = ref.empty_bank(cfg_file, 1, "cpu") if i == 0 \
            else bank_of(state)
        with torch.no_grad():
            out, own = ref.frame_forward(sd, cfg_file, frame, bank)
        state, det = infer(state, frame)
        got = tuple(t.numpy() for t in (det.bboxes, det.scores, det.labels))
        nums = check.frame_numbers(got, out["logits"].double().numpy(),
                                   out["boxes"].double().numpy())
        nums.update(check.bank_numbers(host(bank_of(state)), host(out),
                                       host(own), topk))
        for name in ("score_gap", "centre_max", "size_max", "yaw_max",
                     "velo_max", "logit_max", "emb_p90", "bank_centre_med",
                     "bank_old_max"):
            assert nums[name] <= F32_TOL, (i, name, nums[name])


def test_tiny_vov_spans_and_its_mask_noise():
    """The stages of a VoVNet frame nest inside "backbone+neck" (stem,
    stage2 .. stage5, neck), and the selectors' noise reads no ViT field
    of a VoVNet backbone (inactive)."""
    _, _, model = _model()
    timer = StageTimer("cpu")
    infer = td.eager_infer_fn(model, timer)
    g = torch.Generator().manual_seed(0)
    state = td.init_state(1, model.cfg, device="cpu")
    for t in range(2):
        state, _ = infer(state, td.synthetic_frame(g, t, views=2, height=64,
                                                   width=128, device="cpu"))
    spans = timer.spans()
    names = ("stem", "stage2", "stage3", "stage4", "stage5", "neck")
    assert {p for p, _, _ in spans} == {
        "inputs", "backbone+neck", "head+decode", "head+decode/decoder"} | {
        f"backbone+neck/{n}" for n in names}
    for p0, p1 in ((a, b) for p, a, b in spans if p == "backbone+neck"):
        inside = [p for p, a, b in spans if p0 <= a and b <= p1
                  and p.startswith("backbone+neck/")]
        assert sorted(inside) == sorted(f"backbone+neck/{n}" for n in names)
    noise = td.MaskNoise(model, 5)
    assert not noise.active and noise.draw((1, 2, 64, 128, 3)) is None


# ---------------------------------------------------------------------------
# (c) the preset's weights and the benchmark's layout
# ---------------------------------------------------------------------------

def test_preset_state_dict_is_the_benchmark_layout():
    """Names and shapes of the preset's state dict (buffers the port
    recomputes and the aliased branches aside, as its load drops them) are
    perfbench/encoders/vovnet.layout's plus the shared head's; the
    configuration is the one published (two levels, 256 wide, the ViT
    presets' head)."""
    cfg = get_config(PRESET)
    assert PRESET in PORT_PRESETS and PRESET not in PRESETS
    assert cfg.backbone == VoVNetConfig("V-99-eSE", 3, ("stage4", "stage5"))
    assert cfg.neck == CPFPNConfig((768, 1024), 256, 2)
    assert cfg.head == get_config("stream_petr_eva_vit_l").head
    assert (cfg.pad_shape, cfg.stride, cfg.position_level,
            cfg.compute_dtype) == ((320, 800), 16, 0, "bfloat16")
    with torch.device("meta"):
        model = td.ToC3DDetector(cfg)
    pat = re.compile(td._BUFFER_PAT.pattern)
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not pat.search(k)}
    want = {n: tuple(s) for n, s, _ in weights._spec(_config_file(PRESET))}
    assert have == want
    enc = {n for n, _, _ in ref_vovnet.layout(_config_file(PRESET))}
    assert enc == {k for k in have if k.startswith(("img_backbone.",
                                                    "img_neck."))}
    # 3 stem + 16 blocks x 6 + 4 eSE convolutions, and the neck's 3
    assert sum(k.endswith("conv.weight") or k.endswith("fc.weight")
               for k in enc) == 106


def test_training_and_export_refuse_the_vovnet_backbone(tmp_path):
    from toc3d_tpu_torch.runtime.export import export_detector
    from toc3d_tpu_torch.runtime.train import build_train_packs
    _, _, model = _model()
    for call in (lambda: build_train_packs(model),
                 lambda: export_detector(model, str(tmp_path)),
                 lambda: td.extract_img_feat(
                     model, torch.zeros(1, 1, 64, 128, 3), None, {},
                     train=True)):
        with pytest.raises(NotImplementedError, match="VoVNetConfig"):
            call()


# ---------------------------------------------------------------------------
# (d) precast
# ---------------------------------------------------------------------------

def _unfolded(model, x):
    """The per-call path the port ran before the packs: each weight cast
    to x's dtype, the convolution, then the frozen BatchNorm's scale and
    bias (computed in f32, cast to x's dtype), ReLU; eSE and identity as
    the reference; stage5 out."""
    def conv(c, x):
        b = None if c.bias is None else c.bias.to(x.dtype)
        return F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(x.dtype), b,
                        stride=c.stride, padding=c.padding).permute(0, 2, 3, 1)

    def cbr(seq, x):
        n = seq[1]
        inv = torch.rsqrt(n.running_var + n.eps)
        y = conv(seq[0], x) * (n.weight * inv).to(x.dtype)
        return F.relu(y + (n.bias - n.running_mean * n.weight * inv)
                      .to(x.dtype))
    for i in range(3):
        x = cbr(model.stem[3 * i:3 * i + 3], x)
    for s in range(2, 6):
        if s > 2:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, ceil_mode=True
                             ).permute(0, 2, 3, 1)
        for blk in getattr(model, f"stage{s}"):
            outs, y = [x], x
            for layer in blk.layers:
                y = cbr(layer, y)
                outs.append(y)
            y = cbr(blk.concat, torch.cat(outs, -1))
            if hasattr(blk, "ese"):
                g = conv(blk.ese.fc, y.mean(dim=(1, 2), keepdim=True))
                y = y * ((g + 3.0).clamp(0.0, 6.0) / 6.0)
            x = y + x if blk.identity else y
    return x


def test_precast_packs_the_vovnet_and_keeps_its_output():
    """After precast_backbone_ every convolution of a bf16 VoVNet and its
    neck holds a pack: the weight in bf16, channels-last, the BatchNorm
    folded in (weight x gamma / sqrt(var + eps), beta - mean x scale),
    which a forward reuses and does not rebuild. Its output equals the
    per-call path's (conv, then BatchNorm, each cast per call) within bf16
    rounding: against f32, within 1.5x of the per-call path's own error."""
    _, _, model = _model(compute_dtype="bfloat16")
    td.precast_backbone_(model)
    bb = model.img_backbone
    convs = [m for m in list(bb.modules()) + list(model.img_neck.modules())
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 106
    packs = {}
    for c in convs:
        key, pack = c.__dict__[PACK_CACHE]["conv"]
        assert pack.weight.dtype == torch.bfloat16
        assert pack.weight.is_contiguous(memory_format=torch.channels_last)
        packs[id(c)] = pack
    seq = bb.stage3.OSA3_2.layers[1]
    w, b = fold_conv(seq[0], seq[1])
    n = seq[1]
    scale = n.weight * torch.rsqrt(n.running_var + n.eps)
    torch.testing.assert_close(w, seq[0].weight * scale[:, None, None, None])
    torch.testing.assert_close(b, n.bias - n.running_mean * scale)
    pack = packs[id(seq[0])]
    assert torch.equal(pack.weight, w.to(torch.bfloat16))
    assert torch.equal(pack.bias, b.to(torch.bfloat16))
    x = torch.randn(2, 64, 128, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = vovnet_forward(bb, x.bfloat16())[-1].float()
        old = _unfolded(bb, x.bfloat16()).float()
        truth = _unfolded(bb, x)
    for c in convs:
        assert c.__dict__[PACK_CACHE]["conv"][1] is packs[id(c)]
    rms = lambda a: float(a.square().mean().sqrt())
    err_new, err_old = rms(got - truth), rms(old - truth)
    assert 0 < err_new <= 1.5 * err_old, (err_new, err_old)
    assert err_old <= 0.05 * rms(truth)
    assert math.isfinite(err_new)
