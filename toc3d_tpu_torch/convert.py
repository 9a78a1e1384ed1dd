"""JAX parameter tree -> the port's state dict.

``params_from_jax(params_np, cfg)`` takes the tree the JAX package builds
(``init_detector`` or runtime/checkpoint.convert_detector_checkpoint) as
nested dicts / lists of numpy arrays and returns a state dict with the
reference (mmdet3d) names of ``models.detector.ToC3DDetector``, for either
backbone: a ToC3D tree with its ``score_predictor`` list (either
score_type), or the plain EVA-02 tree of ``init_eva_vit`` (StreamPETR),
which has none; any width (ViT-L, ViT-B). It inverts
the JAX converter's conventions (runtime/checkpoint.py:1-16): a Linear ``w``
is (in, out) and becomes the torch (out, in) weight; a conv ``w`` is
(kh, kw, in, out) and becomes (out, in, kh, kw); MHA q/k/v pack into
in_proj_weight / in_proj_bias; the shared cls/reg branches go to index 0.
Calibrated int8 activation scales (``img_backbone.act_scales``) become each
block's ``act_scales`` entry.

The modules outside the detector have entry points of their own:
``selector_state_from_jax``, ``head_state_from_jax`` (the StreamPETR and
DN heads), ``encoder_state_from_jax``, ``res_bottleneck_state_from_jax``,
``vovnet_state_from_jax`` and ``vit_simple_fpn_state_from_jax``.

``load_reference_checkpoint(path)`` reads a reference ``.pth`` into that
state dict (runtime/checkpoint.load_torch_state_dict, :37-49).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.cuda.int8 import SITES


# the reference head's old parameter names (runtime/checkpoint.py:24-28;
# StreamPETRHead._load_from_state_dict, streampetr_head.py:539-567)
LEGACY_RENAMES = {
    ".self_attn.": ".attentions.0.",
    ".multihead_attn.": ".attentions.1.",
    ".decoder.norm.": ".decoder.post_norm.",
}


def load_reference_checkpoint(path: str) -> dict:
    """A reference checkpoint (.pth) -> the reference-named state dict that
    ``build_detector(..., state_dict=sd)`` loads: tensors on the CPU, the
    ``state_dict`` entry unwrapped where the file has one, legacy names
    renamed. A reference .pth carries non-tensor meta, hence
    weights_only=False: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        for old, new in LEGACY_RENAMES.items():
            if old in k:
                k = k.replace(old, new)
        out[k] = v
    return out


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


class _Out:
    def __init__(self):
        self.sd = {}

    def put(self, key, a):
        self.sd[key] = _t(a)

    def linear(self, pre, p):
        self.put(pre + ".weight", np.asarray(p["w"]).T)
        if "b" in p:
            self.put(pre + ".bias", p["b"])

    def ln(self, pre, p):
        self.put(pre + ".weight", p["scale"])
        self.put(pre + ".bias", p["bias"])

    def conv(self, pre, p):
        self.put(pre + ".weight", np.transpose(np.asarray(p["w"]),
                                               (3, 2, 0, 1)))
        if "b" in p:
            self.put(pre + ".bias", p["b"])

    def conv_transpose(self, pre, p):
        """JAX's conv_transpose kernel (kh, kw, in, out), not transposed,
        is torch's ConvTranspose2d weight (in, out, kh, kw) flipped in
        both spatial axes."""
        self.put(pre + ".weight", np.transpose(
            np.asarray(p["w"])[::-1, ::-1], (2, 3, 0, 1)))
        if "b" in p:
            self.put(pre + ".bias", p["b"])

    def bn(self, pre, p):
        """Frozen BatchNorm (scale, bias, mean, var)."""
        self.put(pre + ".weight", p["scale"])
        self.put(pre + ".bias", p["bias"])
        self.put(pre + ".running_mean", p["mean"])
        self.put(pre + ".running_var", p["var"])
        self.sd[pre + ".num_batches_tracked"] = torch.tensor(0)

    def mln(self, pre, p):
        self.linear(pre + ".reduce.0", p["reduce"])
        self.linear(pre + ".gamma", p["gamma"])
        self.linear(pre + ".beta", p["beta"])

    def mha(self, pre, p):
        self.put(pre + ".in_proj_weight", np.concatenate(
            [np.asarray(p[k]["w"]).T for k in ("q_proj", "k_proj", "v_proj")],
            axis=0))
        self.put(pre + ".in_proj_bias", np.concatenate(
            [np.asarray(p[k]["b"]) for k in ("q_proj", "k_proj", "v_proj")]))
        self.linear(pre + ".out_proj", p["out_proj"])


def block_state_from_jax(blk) -> dict:
    """One EVA block (JAX tree) -> state dict of models.eva_vit.Block."""
    o = _Out()
    a, m = blk["attn"], blk["mlp"]
    o.ln("norm1", blk["norm1"])
    o.put("attn.q_proj.weight", np.asarray(a["q_proj"]["w"]).T)
    o.put("attn.q_bias", a["q_proj"]["b"])
    o.put("attn.k_proj.weight", np.asarray(a["k_proj"]["w"]).T)
    o.put("attn.v_proj.weight", np.asarray(a["v_proj"]["w"]).T)
    o.put("attn.v_bias", a["v_proj"]["b"])
    o.linear("attn.proj", a["proj"])
    o.ln("norm2", blk["norm2"])
    o.linear("mlp.w1", m["w1"])
    o.linear("mlp.w2", m["w2"])
    o.linear("mlp.w3", m["w3"])
    o.ln("mlp.ffn_ln", m["ffn_ln"])
    return o.sd


def selector_state_from_jax(s) -> dict:
    """One token selector (init_selector, either score_type) -> state dict
    of models.token_select.Selector; the 'score' aggregate is the MLPBlock
    aggregate.0.lin1 / lin2 (runtime/checkpoint.py:153-157)."""
    o = _Out()
    sm = s["score_mlp"]
    o.ln("in_conv.0", sm["in_ln"])
    o.linear("in_conv.1", sm["in_fc"])
    o.linear("out_conv.0", sm["out_fc0"])
    o.linear("out_conv.2", sm["out_fc1"])
    o.linear("out_conv.4", sm["out_fc2"])
    o.linear("input_proj.0", s["input_proj"])
    agg = s["aggregate"]
    if "lin1" in agg:
        o.linear("aggregate.0.lin1", agg["lin1"])
        o.linear("aggregate.0.lin2", agg["lin2"])
    else:
        o.linear("aggregate.0", agg)
    o.linear("query_embedding.0", s["query_embedding"]["fc0"])
    o.linear("query_embedding.2", s["query_embedding"]["fc1"])
    o.mln("ego_pose_pe", s["ego_pose_pe"])
    o.mln("ego_pose_queries", s["ego_pose_queries"])
    o.linear("time_embedding.0", s["time_embedding"]["fc"])
    o.ln("time_embedding.1", s["time_embedding"]["ln"])
    return o.sd


def head_state_from_jax(h) -> dict:
    """A StreamPETR head tree (init_streampetr_head; the DN head's
    init_petr_head_dn too) -> state dict of models.streampetr_head.
    StreamPETRHead (keys without the pts_bbox_head. prefix)."""
    o = _Out()
    o.linear("position_encoder.0", h["position_encoder"]["fc0"])
    o.linear("position_encoder.2", h["position_encoder"]["fc1"])
    o.linear("memory_embed.0", h["memory_embed"]["fc0"])
    o.linear("memory_embed.2", h["memory_embed"]["fc1"])
    o.linear("featurized_pe.conv_reduce",
             h["featurized_pe"]["conv_reduce"])
    o.linear("featurized_pe.conv_expand",
             h["featurized_pe"]["conv_expand"])
    o.put("reference_points.weight", h["reference_points"])
    if "pseudo_reference_points" in h:
        o.put("pseudo_reference_points.weight",
              h["pseudo_reference_points"])
    o.linear("query_embedding.0", h["query_embedding"]["fc0"])
    o.linear("query_embedding.2", h["query_embedding"]["fc1"])
    o.mln("spatial_alignment", h["spatial_alignment"])
    o.linear("time_embedding.0", h["time_embedding"]["fc"])
    o.ln("time_embedding.1", h["time_embedding"]["ln"])
    if "ego_pose_pe" in h:
        o.mln("ego_pose_pe", h["ego_pose_pe"])
        o.mln("ego_pose_memory", h["ego_pose_memory"])
    for i, lp in enumerate(h["decoder"]["layers"]):
        lpre = f"transformer.decoder.layers.{i}."
        o.mha(lpre + "attentions.0.attn", lp["self_attn"])
        o.mha(lpre + "attentions.1.attn", lp["cross_attn"])
        o.linear(lpre + "ffns.0.layers.0.0", lp["ffn"]["fc0"])
        o.linear(lpre + "ffns.0.layers.1", lp["ffn"]["fc1"])
        for j in range(3):
            o.ln(lpre + f"norms.{j}", lp[f"norm{j}"])
    o.ln("transformer.decoder.post_norm", h["decoder"]["post_norm"])
    cb, rb = h["cls_branch"], h["reg_branch"]
    o.linear("cls_branches.0.0", cb["fc0"])
    o.ln("cls_branches.0.1", cb["ln0"])
    o.linear("cls_branches.0.3", cb["fc1"])
    o.ln("cls_branches.0.4", cb["ln1"])
    o.linear("cls_branches.0.6", cb["out"])
    o.linear("reg_branches.0.0", rb["fc0"])
    o.linear("reg_branches.0.2", rb["fc1"])
    o.linear("reg_branches.0.4", rb["out"])
    return o.sd


def params_from_jax(params_np, cfg) -> dict:
    """JAX detector params -> reference-named state dict of the port."""
    o = _Out()
    bb = params_np["img_backbone"]
    o.conv("img_backbone.patch_embed.proj", bb["patch_embed"])
    if "pos_embed" in bb:
        o.put("img_backbone.pos_embed", bb["pos_embed"])
    for i, blk in enumerate(bb["blocks"]):
        for k, v in block_state_from_jax(blk).items():
            o.sd[f"img_backbone.blocks.{i}.{k}"] = v
    # calibrated int8 activation scales (ops/int8_calib.attach_act_scales):
    # one (4,) f32 vector per block in SITES order
    for i, s in enumerate(bb.get("act_scales", [])):
        o.put(f"img_backbone.blocks.{i}.act_scales",
              [np.asarray(s[k]).reshape(()) for k in SITES])
    for i, s in enumerate(bb.get("score_predictor", [])):
        for k, v in selector_state_from_jax(s).items():
            o.sd[f"img_backbone.score_predictor.{i}.{k}"] = v

    nk = params_np["img_neck"]
    o.conv("img_neck.lateral_convs.0.conv", nk["lateral0"])
    o.conv("img_neck.fpn_convs.0.conv", nk["fpn0"])

    for k, v in head_state_from_jax(params_np["pts_bbox_head"]).items():
        o.sd["pts_bbox_head." + k] = v

    if "img_roi_head" in params_np:
        f = params_np["img_roi_head"]
        o.conv("img_roi_head.shared_cls.0", f["shared_cls_conv"])
        o.ln("img_roi_head.shared_cls.1", f["shared_cls_gn"])
        o.conv("img_roi_head.shared_reg.0", f["shared_reg_conv"])
        o.ln("img_roi_head.shared_reg.1", f["shared_reg_gn"])
        for n in ("cls", "centerness", "ltrb", "center2d"):
            o.conv(f"img_roi_head.{n}", f[n])
    return o.sd


def encoder_state_from_jax(p) -> dict:
    """A JAX encoder {'layers': [init_encoder_layer ...], 'post_norm':
    optional} -> state dict of models.petr_transformer.Encoder."""
    o = _Out()
    for i, lp in enumerate(p["layers"]):
        pre = f"layers.{i}."
        o.mha(pre + "attentions.0.attn", lp["self_attn"])
        o.linear(pre + "ffns.0.layers.0.0", lp["ffn"]["fc0"])
        o.linear(pre + "ffns.0.layers.1", lp["ffn"]["fc1"])
        o.ln(pre + "norms.0", lp["norm0"])
        o.ln(pre + "norms.1", lp["norm1"])
    if p.get("post_norm"):
        o.ln("post_norm", p["post_norm"])
    return o.sd


def res_bottleneck_state_from_jax(p) -> dict:
    """init_res_bottleneck's tree -> state dict of
    models.eva_vit.ResBottleneck."""
    o = _Out()
    for i in (1, 2, 3):
        o.conv(f"conv{i}", p[f"conv{i}"])
        o.ln(f"norm{i}", p[f"norm{i}"])
    return o.sd


def vovnet_state_from_jax(p) -> dict:
    """init_vovnet's tree -> state dict of models.vovnet.VoVNet, the
    reference's names."""
    o = _Out()

    def cbr(pre, name, q):
        o.conv(f"{pre}.{name}/conv", q["conv"])
        o.bn(f"{pre}.{name}/norm", q["norm"])

    for i in range(3):
        cbr("stem", f"stem_{i + 1}", p[f"stem{i + 1}"])
    for i, blocks in enumerate(p["stages"]):
        for j, bp in enumerate(blocks):
            name = f"OSA{i + 2}_{j + 1}"
            pre = f"stage{i + 2}.{name}"
            for li, lp in enumerate(bp["layers"]):
                cbr(f"{pre}.layers.{li}", f"{name}_{li}", lp)
            cbr(f"{pre}.concat", f"{name}_concat", bp["concat"])
            if "ese_fc" in bp:
                o.conv(f"{pre}.ese.fc", bp["ese_fc"])
    return o.sd


def vit_simple_fpn_state_from_jax(p) -> dict:
    """init_vit_simple_fpn's tree -> state dict of
    models.vit_simple_fpn.ViTSimpleFPN."""
    o = _Out()
    for i, st in enumerate(p["stages"]):
        for name, q in st.items():
            pre = f"stages.{i}.{name}"
            if name.startswith("up"):
                o.conv_transpose(pre, q)
            elif name == "gn1":
                o.ln(pre, q)
            else:
                o.conv(pre, q)
    return o.sd
