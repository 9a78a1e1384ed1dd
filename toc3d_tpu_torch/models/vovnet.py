"""VoVNet / VoVNetCP CNN backbone, V2 OSA modules with eSE and identity
(counterpart of toc3d_tpu/models/vovnet.py; reference backbones/
vovnetcp.py): the backbone of StreamPETR's V2-99 configuration
(configs/presets.stream_petr_vov_flash_800_bs2_seq_24e), which
models/detector.py builds for a VoVNetConfig.

Module names are the reference's: stem.stem_{1,2,3}/{conv,norm},
stage{2..5}.OSA{s}_{j}.layers.{i}.OSA{s}_{j}_{i}/{conv,norm},
...concat.OSA{s}_{j}_concat/{conv,norm}, ...ese.fc. Every block after a
stage's first adds its input. The eSE gate sits on each stage's last
block, as the JAX package reads vovnetcp.py (vovnet.py:122-127). That
placement is an assumption: one reading of the public ``_OSA_stage`` gives
eSE to single-block stages only, and only a checkpoint's key set settles
it. It costs at most one 1x1 convolution of a pooled vector a stage.

BatchNorm is frozen (the reference trains with norm_eval): an affine map of
the stored statistics, folded into its convolution's weight and bias in
f32 (ops/cuda/conv.fold_conv), so a convolution, its BatchNorm and its
ReLU are one convolution with a bias and a ReLU: one fused cuDNN call on
the card. The convolutions are cuDNN's, as JAX's are XLA's, on
channel-last maps, through the packs of ops/cuda/conv (the weight in the
activation dtype, channels-last, built once by
detector.precast_backbone_), so a captured frame casts no weight and
transposes none. Inference only: the packs hold no autograd history.

Stage spans (runtime/timer.stage): "stem" and "stage2" .. "stage5" inside
the current timer's open span ("backbone+neck" in a served frame).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.conv import pack_conv, packed_conv2d
from ..runtime.timer import stage

STAGE_SPECS: Dict[str, Dict] = {
    "V-39-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 2, 2), eSE=True, dw=False),
    "V-57-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 4, 3), eSE=True, dw=False),
    "V-99-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 3, 9, 3), eSE=True, dw=False),
}


@dataclass(frozen=True)
class VoVNetConfig:
    spec_name: str = "V-99-eSE"
    input_ch: int = 3
    out_features: Tuple[str, ...] = ("stage4", "stage5")

    @property
    def spec(self) -> Dict:
        return STAGE_SPECS[self.spec_name]


def _cbr(cin: int, cout: int, name: str, postfix, stride: int = 1,
         k: int = 3) -> nn.Sequential:
    """Conv (no bias) -> BatchNorm -> ReLU with the reference's names."""
    return nn.Sequential(OrderedDict([
        (f"{name}_{postfix}/conv", nn.Conv2d(cin, cout, k, stride, k // 2,
                                             bias=False)),
        (f"{name}_{postfix}/norm", nn.BatchNorm2d(cout)),
        (f"{name}_{postfix}/relu", nn.ReLU())]))


class ESE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)


class OSAModule(nn.Module):
    """One OSA block: layer_per_block 3x3 CBRs, their concatenation with the
    input through a 1x1 CBR, the eSE gate when ``ese``, and the identity add
    when ``identity``."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, name: str, ese: bool, identity: bool):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList(
            _cbr(in_ch if i == 0 else stage_ch, stage_ch, name, i)
            for i in range(layer_per_block))
        self.concat = _cbr(in_ch + layer_per_block * stage_ch, concat_ch,
                           name, "concat", k=1)
        if ese:
            self.ese = ESE(concat_ch)


class VoVNet(nn.Module):
    def __init__(self, cfg: VoVNetConfig):
        super().__init__()
        self.cfg = cfg
        spec = cfg.spec
        s = spec["stem"]
        stem = OrderedDict()
        for i, (cin, cout, stride) in enumerate(
                ((cfg.input_ch, s[0], 2), (s[0], s[1], 1), (s[1], s[2], 2))):
            stem.update(_cbr(cin, cout, "stem", i + 1, stride)._modules)
        self.stem = nn.Sequential(stem)
        in_ch = s[2]
        for i in range(4):
            sn = i + 2
            blocks = OrderedDict()
            nb = spec["block_per_stage"][i]
            for b in range(nb):
                name = f"OSA{sn}_{b + 1}"
                blocks[name] = OSAModule(
                    in_ch if b == 0 else spec["stage_out_ch"][i],
                    spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                    spec["layer_per_block"], name,
                    ese=spec["eSE"] and b == nb - 1, identity=b > 0)
            self.add_module(f"stage{sn}", nn.Sequential(blocks))
            in_ch = spec["stage_out_ch"][i]


def cbr_forward(seq: nn.Sequential, x):
    """Conv -> frozen BatchNorm -> ReLU of a channel-last map, the norm
    folded into the convolution (one fused cuDNN call on the card)."""
    return packed_conv2d(seq[0], x, seq[1], relu=True)


def osa_forward(m: OSAModule, x):
    """vovnetcp.py _OSA_module._forward (vovnet.py:90-107)."""
    outs = [x]
    y = x
    for layer in m.layers:
        y = cbr_forward(layer, y)
        outs.append(y)
    y = cbr_forward(m.concat, torch.cat(outs, dim=-1))
    if hasattr(m, "ese"):
        g = F.hardsigmoid(packed_conv2d(m.ese.fc,
                                        y.mean(dim=(1, 2), keepdim=True)))
        return torch.addcmul(x, y, g) if m.identity else y * g
    return y + x if m.identity else y


def maxpool_ceil(x, k: int = 3, s: int = 2):
    """MaxPool2d(k, s, ceil_mode=True) of a channel-last map."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s,
                        ceil_mode=True).permute(0, 2, 3, 1)


def pack_vovnet(model: VoVNet, dtype) -> None:
    """Build the pack of every convolution of ``model`` in ``dtype`` (each
    BatchNorm folded into the convolution before it), so that a frame
    builds none (ops/cuda/conv.pack_conv; cached until the weights
    change)."""
    for mod in model.modules():
        if isinstance(mod, nn.Sequential):
            for conv, norm in zip(mod, mod[1:]):
                if isinstance(norm, nn.BatchNorm2d):
                    pack_conv(conv, dtype, norm)
        elif isinstance(mod, ESE):
            pack_conv(mod.fc, dtype)


def vovnet_forward(model: VoVNet, x):
    """x (B, H, W, 3) -> the list of cfg.out_features maps ('stem',
    'stage2' .. 'stage5', strides 4 .. 32), channel-last, in x's dtype
    (vovnet.py:143-160)."""
    cfg = model.cfg
    with stage("stem"):
        for i in range(3):
            x = cbr_forward(model.stem[3 * i:3 * i + 3], x)
    outs = [x] if "stem" in cfg.out_features else []
    for i in range(4):
        with stage(f"stage{i + 2}"):
            if i:
                x = maxpool_ceil(x)
            for blk in getattr(model, f"stage{i + 2}"):
                x = osa_forward(blk, x)
        if f"stage{i + 2}" in cfg.out_features:
            outs.append(x)
    return outs
