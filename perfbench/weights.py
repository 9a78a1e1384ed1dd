"""Seeded random weights under the reference (mmdet3d) parameter names, made
on the device in a few generator calls.

The layout is the reference checkpoint's. Its first part is the image
encoder's own (perfbench/encoders: the configuration file's ``encoder``
gives its ``layout``); the rest is shared by every encoder: the StreamPETR
head with its shared branches stored once (index 0) and the 2D FocalHead.
The distributions are the benchmark's own choice: every linear and
convolution weight normal with standard deviation 1 / sqrt(fan_in), so
activations keep unit scale through deep stacks; biases and tables normal
at 0.02; every LayerNorm's and GroupNorm's weight 1 + N(0, 0.1) and bias
N(0, 0.1), as trained norms are never at their initial 1 and 0, but for
the outlier channels below; the query and pseudo reference points uniform
in [0, 1); the classifier's bias at the 0.01 prior probability. Float32,
as both the program and the reference load them.

Outlier channels: trained transformers carry a few channels far larger
than the rest, the inter-channel variation that post-training quantization
has to handle. An encoder marks the norms that carry them (kind 'nwo':
1% of their channels at weight 10; the EVA-02 ViT marks those in front of
its blocks' weight products). In the decoder they sit in the FFNs' hidden
layers, where they meet small weights in the product that reads them: 1%
of each FFN's hidden channels run 30 times larger, read at 1/30, which
leaves the function as it is. Such channels set the scale of a row
quantized to int8, as they do on trained weights. The decoder's LayerNorms
carry none: channels there would feed the attention logits, and at weight
4 to 10 they made the random head's attention so sharp that its bf16 error
swung 4x from seed to seed.
"""
from __future__ import annotations

import math
import re

import torch

from . import encoders

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
NORM_SPREAD = 0.1
OUTLIER_SHARE = 0.01
# a norm of kind 'nwo': a share OUTLIER_SHARE of its channels (rounded, at
# least one) drawn from the seed carries the weight OUTLIER_WEIGHT
OUTLIER_WEIGHT = 10.0
# the decoder's FFNs: in each, a share OUTLIER_SHARE of the hidden channels
# drawn from the seed runs FFN_OUTLIER_GAIN times larger (the rows of the
# first layer's weight and bias), and the second layer reads them at its
# inverse (its input columns), so the function is the same
FFN_FIRST = r"transformer\.decoder\.layers\.\d+\.ffns\.0\.layers\.0\.0\."
FFN_OUTLIER_GAIN = 30.0


class Layout(list):
    """[(name, shape, kind)]: kind 'w' (fan-in normal), 'b' (normal 0.02),
    'nw' (a norm's weight), 'nwo' (a norm's weight with outlier channels),
    'nb' (a norm's bias), 'u' (uniform [0, 1)); appended by layer."""

    def lin(self, name, din, dout, bias=True):
        self.append((name + ".weight", (dout, din), "w"))
        if bias:
            self.append((name + ".bias", (dout,), "b"))

    def norm(self, name, d, outliers=False):
        self.append((name + ".weight", (d,), "nwo" if outliers else "nw"))
        self.append((name + ".bias", (d,), "nb"))

    def conv(self, name, cin, cout, k):
        self.append((name + ".weight", (cout, cin, k, k), "w"))
        self.append((name + ".bias", (cout,), "b"))

    def mln(self, name, cdim, fdim):
        self.lin(name + ".reduce.0", cdim, fdim)
        self.lin(name + ".gamma", fdim, fdim)
        self.lin(name + ".beta", fdim, fdim)


def _spec(cfg):
    """The whole model's layout: the encoder's, then the head's and the
    FocalHead's."""
    hc = cfg["head"]
    out = Layout(encoders.load(cfg).layout(cfg))
    lin, norm, conv, mln = out.lin, out.norm, out.conv, out.mln
    e = hc["embed_dims"]
    h = "pts_bbox_head."
    lin(h + "position_encoder.0", hc["depth_num"] * 3, e * 4)
    lin(h + "position_encoder.2", e * 4, e)
    lin(h + "memory_embed.0", hc["in_channels"], e)
    lin(h + "memory_embed.2", e, e)
    lin(h + "featurized_pe.conv_reduce", e, e)
    lin(h + "featurized_pe.conv_expand", e, e)
    out.append((h + "reference_points.weight", (hc["num_query"], 3), "u"))
    out.append((h + "pseudo_reference_points.weight",
                (hc["num_propagated"], 3), "u"))
    lin(h + "query_embedding.0", e * 3 // 2, e)
    lin(h + "query_embedding.2", e, e)
    mln(h + "spatial_alignment", 8, e)
    lin(h + "time_embedding.0", e, e)
    norm(h + "time_embedding.1", e)
    mln(h + "ego_pose_pe", 180, e)
    mln(h + "ego_pose_memory", 180, e)
    dc = hc["decoder"]
    for i in range(dc["num_layers"]):
        pre = h + f"transformer.decoder.layers.{i}."
        for a in (0, 1):
            out.append((pre + f"attentions.{a}.attn.in_proj_weight",
                        (3 * e, e), "w"))
            out.append((pre + f"attentions.{a}.attn.in_proj_bias", (3 * e,),
                        "b"))
            lin(pre + f"attentions.{a}.attn.out_proj", e, e)
        lin(pre + "ffns.0.layers.0.0", e, dc["feedforward_channels"])
        lin(pre + "ffns.0.layers.1", dc["feedforward_channels"], e)
        for j in range(3):
            norm(pre + f"norms.{j}", e)
    norm(h + "transformer.decoder.post_norm", e)
    bp, rp = h + "cls_branches.0.", h + "reg_branches.0."
    lin(bp + "0", e, e)
    norm(bp + "1", e)
    lin(bp + "3", e, e)
    norm(bp + "4", e)
    lin(bp + "6", e, hc["num_classes"])
    lin(rp + "0", e, e)
    lin(rp + "2", e, e)
    lin(rp + "4", e, hc["code_size"])
    fc = cfg["focal"]
    fe, fi = fc["embed_dims"], fc["in_channels"]
    for br in ("shared_cls", "shared_reg"):
        conv(f"img_roi_head.{br}.0", fi, fe, 3)
        norm(f"img_roi_head.{br}.1", fe)
    for n, c in (("cls", fc["num_classes"]), ("centerness", 1), ("ltrb", 4),
                 ("center2d", 2)):
        conv(f"img_roi_head.{n}", fe, c, 1)
    return out


def make_state_dict(cfg, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} drawn from ``seed``: one normal
    and one uniform draw for the whole model, sliced in the layout's
    order, then scaled (or, for outlier channels, replaced) in place, and
    one small uniform draw a decoder FFN for its outlier channels."""
    spec = _spec(cfg)
    numel = lambda s: math.prod(s)
    n_norm = sum(numel(s) for _, s, k in spec if k != "u")
    n_unif = sum(numel(s) for _, s, k in spec if k in ("u", "nwo"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_norm, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device)
    scale = {"b": 0.02, "nw": NORM_SPREAD, "nwo": NORM_SPREAD,
             "nb": NORM_SPREAD}
    sd, i, j = {}, 0, 0
    with torch.no_grad():
        for name, shape, kind in spec:
            n = numel(shape)
            if kind == "u":
                sd[name] = unif[j:j + n].view(shape)
                j += n
                continue
            t = normal[i:i + n].view(shape)
            i += n
            t.mul_((n // shape[0]) ** -0.5 if kind == "w" else scale[kind])
            if kind in ("nw", "nwo"):
                t.add_(1.0)
            if kind == "nwo":
                count = max(1, round(OUTLIER_SHARE * n))
                t[unif[j:j + n].topk(count).indices] = OUTLIER_WEIGHT
                j += n
            sd[name] = t
        sd["pts_bbox_head.cls_branches.0.6.bias"].add_(PRIOR_BIAS)
        for name in [n for n in sd if re.search(FFN_FIRST + "weight$", n)]:
            hid = sd[name].shape[0]
            rows = torch.rand(hid, generator=g, device=device).topk(
                max(1, round(OUTLIER_SHARE * hid))).indices
            sd[name][rows] *= FFN_OUTLIER_GAIN
            sd[name[:-len("weight")] + "bias"][rows] *= FFN_OUTLIER_GAIN
            second = name.replace("layers.0.0.weight", "layers.1.weight")
            sd[second][:, rows] /= FFN_OUTLIER_GAIN
    return sd
