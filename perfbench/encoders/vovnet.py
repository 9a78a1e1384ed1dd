"""The VoVNet-99-eSE (V2-99) image encoder of StreamPETR's CNN configuration
and its two-level CPFPN neck: its weight layout, its plain float32
reference, its operation count and its int8 switch (the interface is
perfbench/encoders/__init__.py).

Reference semantics, each as the published code (VoVNetCP, CPFPN) has it:
* a conv-BN-ReLU ("CBR") is a convolution without bias (padding k // 2),
  a BatchNorm over the stored statistics (frozen: norm_eval), then ReLU;
* the stem: three 3x3 CBRs of strides 2, 1, 2;
* stages 2 to 5, a ceil-mode 3x3 / 2 max-pool in front of stages 3 to 5;
  each stage a chain of OSA blocks. An OSA block: five 3x3 CBRs in a chain,
  their concatenation after the block's input, a 1x1 CBR to the stage's
  width, on the stage's last block the eSE gate (the channels' global
  mean, a 1x1 convolution with bias, hard sigmoid relu6(x + 3) / 6, times
  the map), and on every block after a stage's first the block's input
  added;
* the neck: a 1x1 lateral convolution (with bias) on each of the
  out_features levels, the coarser level's lateral nearest-upsampled to the
  finer one's size and added to it, then a 3x3 convolution (with bias) on
  level 0, the level the head reads.
The eSE placement (a stage's last block) is an assumption, recorded in the
configuration file's ``assumed``.

Counting (``flops``; the rules of perfbench/counting.py): every
convolution is a product of its output pixels x C_out by C_in x k x k, at
the map sizes the strides and the ceil-mode pools give; the eSE
convolutions are C x C a map; the upsampling, the additions and the
norms are not counted.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..counting import mm
from ..weights import Layout

IMG_NORM_MEAN = (103.530, 116.280, 123.675)
IMG_NORM_STD = (57.375, 57.120, 58.395)
BN_EPS = 1e-5

# VoVNetCP's published stage specifications (vovnetcp.py)
SPECS = {
    "V-39-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 2, 2)),
    "V-57-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 4, 3)),
    "V-99-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 3, 9, 3)),
}


def _spec(cfg):
    return SPECS[cfg["backbone"]["spec_name"]]


def convs(cfg):
    """[(prefix, C_in, C_out, k, stride, kind)] of the backbone's
    convolutions in order, kind 'cbr' (a BatchNorm and ReLU follow), 'ese'
    (the gate's, with bias) or 'pool' (no convolution: the ceil-mode max-pool
    in front of a stage; C_in, C_out its width, k 3, stride 2)."""
    spec = _spec(cfg)
    s = spec["stem"]
    out = []
    cin = cfg["backbone"]["input_ch"]
    for i, (cout, stride) in enumerate(zip(s, (2, 1, 2))):
        out.append((f"stem.stem_{i + 1}", cin, cout, 3, stride, "cbr"))
        cin = cout
    for i in range(4):
        sn, ch, oc = i + 2, spec["stage_conv_ch"][i], spec["stage_out_ch"][i]
        if i:
            out.append((f"stage{sn}", cin, cin, 3, 2, "pool"))
        nb = spec["block_per_stage"][i]
        for b in range(nb):
            name = f"OSA{sn}_{b + 1}"
            pre = f"stage{sn}.{name}."
            bin_ = cin if b == 0 else oc
            for j in range(spec["layer_per_block"]):
                out.append((f"{pre}layers.{j}.{name}_{j}",
                            bin_ if j == 0 else ch, ch, 3, 1, "cbr"))
            out.append((f"{pre}concat.{name}_concat",
                        bin_ + spec["layer_per_block"] * ch, oc, 1, 1,
                        "cbr"))
            if b == nb - 1:
                out.append((f"{pre}ese.fc", oc, oc, 1, 1, "ese"))
        cin = oc
    return out


# ---------------------------------------------------------------------------
# weight layout
# ---------------------------------------------------------------------------

def layout(cfg):
    """Every convolution and frozen BatchNorm of the backbone (running mean
    of kind 'nb', running variance of kind 'nw', and the counter
    num_batches_tracked that the reference's checkpoints carry and nothing
    reads), then the neck's lateral and level-0 convolutions."""
    out = Layout()
    for pre, cin, cout, k, _, kind in convs(cfg):
        name = "img_backbone." + pre
        if kind == "pool":
            continue
        if kind == "ese":
            out.conv(name, cin, cout, k)
            continue
        out.append((name + "/conv.weight", (cout, cin, k, k), "w"))
        out.norm(name + "/norm", cout)
        out.append((name + "/norm.running_mean", (cout,), "nb"))
        out.append((name + "/norm.running_var", (cout,), "nw"))
        out.append((name + "/norm.num_batches_tracked", (), "b"))
    nc = cfg["neck"]
    oc = nc["out_channels"]
    for i, c in enumerate(nc["in_channels"]):
        out.conv(f"img_neck.lateral_convs.{i}.conv", c, oc, 1)
    out.conv("img_neck.fpn_convs.0.conv", oc, oc, 3)
    return out


# ---------------------------------------------------------------------------
# plain reference
# ---------------------------------------------------------------------------

def _cbr(sd, name, x, stride):
    w = sd[name + "/conv.weight"]
    x = F.conv2d(x, w, None, stride=stride, padding=w.shape[-1] // 2)
    x = F.batch_norm(x, sd[name + "/norm.running_mean"],
                     sd[name + "/norm.running_var"],
                     sd[name + "/norm.weight"], sd[name + "/norm.bias"],
                     training=False, eps=BN_EPS)
    return F.relu(x)


def backbone(sd, cfg, img):
    """(B, N, H, W, 3) uint8 BGR images -> {stage name: NCHW map} of the
    configuration's out_features."""
    spec = _spec(cfg)
    b, n, hh, ww, _ = img.shape
    mean = torch.tensor(IMG_NORM_MEAN, device=img.device)
    std = torch.tensor(IMG_NORM_STD, device=img.device)
    x = ((img.float() - mean) / std).reshape(b * n, hh, ww, 3)
    x = x.permute(0, 3, 1, 2)
    for i, stride in enumerate((2, 1, 2)):
        x = _cbr(sd, f"img_backbone.stem.stem_{i + 1}", x, stride)
    wanted = cfg["backbone"]["out_features"]
    outs = {"stem": x} if "stem" in wanted else {}
    for i in range(4):
        sn, nb = i + 2, spec["block_per_stage"][i]
        if i:
            x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for blk in range(nb):
            name = f"OSA{sn}_{blk + 1}"
            pre = f"img_backbone.stage{sn}.{name}."
            cat, y = [x], x
            for j in range(spec["layer_per_block"]):
                y = _cbr(sd, f"{pre}layers.{j}.{name}_{j}", y, 1)
                cat.append(y)
            y = _cbr(sd, f"{pre}concat.{name}_concat", torch.cat(cat, 1), 1)
            if blk == nb - 1:
                g = F.conv2d(y.mean(dim=(2, 3), keepdim=True),
                             sd[pre + "ese.fc.weight"],
                             sd[pre + "ese.fc.bias"])
                y = y * (F.relu6(g + 3.0) / 6.0)
            x = y + x if blk else y
        if f"stage{sn}" in wanted:
            outs[f"stage{sn}"] = x
    return outs


def neck(sd, cfg, levels):
    """CPFPN over the out_features levels (finest first): laterals, the
    top-down sum, level 0's 3x3 convolution; channel-last level 0."""
    lats = [F.conv2d(x, sd[f"img_neck.lateral_convs.{i}.conv.weight"],
                     sd[f"img_neck.lateral_convs.{i}.conv.bias"])
            for i, x in enumerate(levels)]
    for i in range(len(lats) - 1, 0, -1):
        lats[i - 1] = lats[i - 1] + F.interpolate(
            lats[i], size=lats[i - 1].shape[2:], mode="nearest")
    y = F.conv2d(lats[0], sd["img_neck.fpn_convs.0.conv.weight"],
                 sd["img_neck.fpn_convs.0.conv.bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def features(sd, cfg, img, bank, frame):
    """(B, N, H, W, 3) uint8 BGR images -> (B*N, h, w, C): the backbone's
    out_features levels through the neck, level 0."""
    outs = backbone(sd, cfg, img)
    return neck(sd, cfg, [outs[s] for s in cfg["backbone"]["out_features"]])


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def _out(n, k, stride, ceil=False):
    """Output length of a convolution (padding k // 2) or a ceil-mode
    pool (no padding) of ``n`` inputs."""
    if ceil:
        return math.ceil((n - k) / stride) + 1
    return (n + 2 * (k // 2) - k) // stride + 1


def conv_shapes(cfg, views: int, batch: int):
    """[(label, M, N, K, input elements)] of one frame's convolutions as
    products: M output pixels of all maps, N = C_out, K = C_in x k x k, and
    the input map's elements; the backbone's, then the neck's. Sizes follow
    the strides and the ceil-mode pools from pad_shape."""
    maps = batch * views
    h, w = cfg["pad_shape"]
    sizes, out = {}, []
    for pre, cin, cout, k, stride, kind in convs(cfg):
        if kind == "pool":
            h, w = _out(h, k, stride, True), _out(w, k, stride, True)
        elif kind == "ese":
            out.append((pre, maps, cout, cin, maps * cin))
        else:
            ho, wo = _out(h, k, stride), _out(w, k, stride)
            out.append((pre, maps * ho * wo, cout, cin * k * k,
                        maps * h * w * cin))
            h, w = ho, wo
            sizes[pre.split(".")[0]] = (h, w)
    nc = cfg["neck"]
    oc = nc["out_channels"]
    level = [maps * math.prod(sizes[s])
             for s in cfg["backbone"]["out_features"]]
    for i, (c, px) in enumerate(zip(nc["in_channels"], level)):
        out.append((f"neck.lateral.{i}", px, oc, c, px * c))
    out.append(("neck.fpn.0", level[0], oc, oc * 9, level[0] * oc))
    return out


def flops(cfg: dict, views: int, batch: int) -> float:
    """Operations of one frame: every convolution of the backbone (the eSE
    gates' included) and of the neck."""
    return sum(mm(m, n, k) for _, m, n, k, _ in conv_shapes(cfg, views,
                                                             batch))


def conv_launches(cfg: dict, views: int, batch: int):
    """[(label, operations, bytes)] of one frame's convolutions, bytes the
    input map, the weight and the output each once in bf16."""
    return [(lab, mm(m, n, k), 2.0 * (x + n * k + m * n))
            for lab, m, n, k, x in conv_shapes(cfg, views, batch)]


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------

def control(program_cfg):
    """Unchanged: the program has no int8 path for VoVNet, so the control
    is the decoder's int8 alone (perfbench/program.program_config)."""
    return program_cfg
