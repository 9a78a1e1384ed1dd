"""Named presets (counterpart of toc3d_tpu/configs/presets.py): the same ten
names, the ToC3D_ratio* sweep names and apply_overrides. Constants, presets
and helpers are copied from presets.py:20-245, training fields included
(grid mask, DN and loss settings, frame-gradient counts); the JAX
package's fused_blocks switch is not carried (the port always runs its
kernels on the card). PORT_PRESETS holds the configurations that the port
runs and the JAX package has no preset for: StreamPETR's V2-99 (VoVNet-99-
eSE) and its CPU-test size."""
from __future__ import annotations

from ..models.detector import DetectorConfig, FocalHeadConfig
from ..models.eva_vit import EVAViTConfig
from ..models.neck import CPFPNConfig
from ..models.petr_transformer import DecoderConfig
from ..models.streampetr_head import StreamPETRHeadConfig
from ..models.toc3d_vit import ToC3DViTConfig
from ..models.vovnet import VoVNetConfig

POINT_CLOUD_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
POSITION_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)

# nuScenes class names in label order (ToC3D_fast.py:16-19)
CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")

# image normalization (ToC3D_fast.py:13-14), BGR order (to_rgb=False)
IMG_NORM_MEAN = (103.530, 116.280, 123.675)
IMG_NORM_STD = (57.375, 57.120, 58.395)


def _vit_l_kwargs():
    """EVA-02 ViT-L settings of the shipped configs (ToC3D_fast.py:41-69)."""
    return dict(
        img_size=320, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        mlp_ratio=4 * 2 / 3, window_size=16, global_window_size=20,
        global_attn_indexes=(2, 5, 8, 11, 14, 17, 20, 23),
        drop_path_rate=0.3, pt_hw_seq_len=16, intp_freq=True,
        pretrain_img_size=224, pretrain_use_cls_token=True)


def _vit_b_kwargs():
    """EVA-02 ViT-B (paper Table 2 rows; no reference config shipped,
    presets.py:51-60)."""
    return dict(
        img_size=320, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        mlp_ratio=4 * 2 / 3, window_size=16, global_window_size=20,
        global_attn_indexes=(2, 5, 8, 11), drop_path_rate=0.3,
        pt_hw_seq_len=16, intp_freq=True, pretrain_img_size=224,
        pretrain_use_cls_token=True)


def _head(compute_dtype="float32") -> StreamPETRHeadConfig:
    return StreamPETRHeadConfig(
        compute_dtype=compute_dtype,
        num_classes=10, in_channels=256, embed_dims=256, stride=16,
        num_query=644, memory_len=1024, topk_proposals=256,
        num_propagated=256, with_ego_pos=True, scalar=10, noise_scale=1.0,
        dn_weight=1.0, split=0.75, LID=True, depth_num=64, depth_start=1.0,
        position_range=POSITION_RANGE, pc_range=POINT_CLOUD_RANGE,
        code_weights=(2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
        decoder=DecoderConfig(embed_dims=256, num_heads=8, num_layers=6,
                              feedforward_channels=2048, dropout=0.1),
        max_decode=300, post_center_range=POSITION_RANGE)


def _detector(backbone, pad_shape, compute_dtype="bfloat16",
              vit_b=False, in_channels=None) -> DetectorConfig:
    """presets.py:77-89: the neck takes the backbone's width (768 for
    ViT-B), or the widths of its output levels ``in_channels``."""
    in_ch = in_channels or ((768,) if vit_b else (1024,))
    return DetectorConfig(
        backbone=backbone,
        neck=CPFPNConfig(in_channels=in_ch, out_channels=256, num_outs=2),
        head=_head(compute_dtype),
        focal=FocalHeadConfig(num_classes=10, in_channels=256,
                              embed_dims=256, stride=16),
        use_grid_mask=True, aux_2d_only=True, stride=16, position_level=0,
        num_frame_backbone_grads=1, num_frame_head_grads=1,
        num_frame_losses=1, pad_shape=pad_shape,
        compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# presets (reference config name -> DetectorConfig)
# ---------------------------------------------------------------------------

def stream_petr_eva_vit_l(**kw) -> DetectorConfig:
    """StreamPETR ViT-L baseline, 800x320, no pruning
    (projects/configs/StreamPETR/stream_petr_eva_vit_l.py)."""
    return _detector(EVAViTConfig(**_vit_l_kwargs()), (320, 800), **kw)


def stream_petr_eva_vit_l_1600(**kw) -> DetectorConfig:
    """(projects/configs/StreamPETR/stream_petr_eva_vit_l_1600.py)."""
    return _detector(EVAViTConfig(**_vit_l_kwargs()), (800, 1600), **kw)


def _toc3d_backbone(ratios, base_kwargs=None, num_queries=64,
                    pruning_loc=(6, 12, 18)):
    return ToC3DViTConfig(
        pruning_loc=pruning_loc, token_ratio=tuple(ratios),
        pruning_num_queries=num_queries, pruning_score_type="attention",
        pruning_attn_scale=True, score_mask=True, accelerate_global=True,
        use_represent_tokens=True, rope_acc=True, query_dim=256,
        pc_range=POINT_CLOUD_RANGE, **(base_kwargs or _vit_l_kwargs()))


def toc3d_fast(**kw) -> DetectorConfig:
    """ToC3D-Fast, ratios 7/5/5, 800x320 (projects/configs/ToC3D/ToC3D_fast.py)."""
    return _detector(_toc3d_backbone((0.7, 0.5, 0.5)), (320, 800), **kw)


def toc3d_faster(**kw) -> DetectorConfig:
    """ToC3D-Faster, ratios 5/4/3 (projects/configs/ToC3D/ToC3D_faster.py)."""
    return _detector(_toc3d_backbone((0.5, 0.4, 0.3)), (320, 800), **kw)


def toc3d_fast_1600(**kw) -> DetectorConfig:
    """(projects/configs/ToC3D_1600_resolution/ToC3D_fast_1600.py)."""
    return _detector(_toc3d_backbone((0.7, 0.5, 0.5)), (800, 1600), **kw)


def toc3d_faster_1600(**kw) -> DetectorConfig:
    """ToC3D-Faster at 1600x800, ratios .5/.4/.3, bf16 backbone
    (projects/configs/ToC3D_1600_resolution/ToC3D_faster_1600.py)."""
    return _detector(_toc3d_backbone((0.5, 0.4, 0.3)), (800, 1600), **kw)


def toc3d_ratio_sweep(r1: int, r2: int, r3: int, res1600=False,
                      **kw) -> DetectorConfig:
    """Speed-test ratio sweeps, e.g. (5,4,3) == ToC3D_ratio543
    (projects/configs/test_speed_ToC3D*/)."""
    ratios = (r1 / 10.0, r2 / 10.0, r3 / 10.0)
    pad = (800, 1600) if res1600 else (320, 800)
    return _detector(_toc3d_backbone(ratios), pad, **kw)


# The reference ships no ViT-B config. Its ViT-L configs prune at the depth
# fractions 1/4, 1/2, 3/4 of 24 = (6, 12, 18); at depth 12 that would leave
# layers 12 and 18 out of range, so ViT-B takes the proportional schedule
# (presets.py:146-152).
_VIT_B_PRUNING_LOC = (3, 6, 9)


def stream_petr_vit_b(**kw) -> DetectorConfig:
    """StreamPETR ViT-B baseline, 800x320, no pruning (paper Table 2 ViT-B
    rows; no reference config shipped)."""
    return _detector(EVAViTConfig(**_vit_b_kwargs()), (320, 800),
                     vit_b=True, **kw)


def toc3d_vit_b_fast(**kw) -> DetectorConfig:
    return _detector(_toc3d_backbone((0.7, 0.5, 0.5), _vit_b_kwargs(),
                                     pruning_loc=_VIT_B_PRUNING_LOC),
                     (320, 800), vit_b=True, **kw)


def toc3d_vit_b_faster(**kw) -> DetectorConfig:
    return _detector(_toc3d_backbone((0.5, 0.4, 0.3), _vit_b_kwargs(),
                                     pruning_loc=_VIT_B_PRUNING_LOC),
                     (320, 800), vit_b=True, **kw)


def tiny_test_config(**kw) -> DetectorConfig:
    """Small config for CPU tests (presets.py:174-193)."""
    backbone = ToC3DViTConfig(
        img_size=64, patch_size=16, embed_dim=64, depth=4, num_heads=2,
        window_size=4, global_window_size=4, global_attn_indexes=(1, 3),
        pretrain_img_size=32, pruning_loc=(2,), token_ratio=(0.5,),
        pruning_num_queries=4, query_dim=64, pc_range=POINT_CLOUD_RANGE)
    defaults = dict(
        backbone=backbone,
        neck=CPFPNConfig(in_channels=(64,), out_channels=32),
        head=StreamPETRHeadConfig(
            embed_dims=64, in_channels=32, num_query=24, memory_len=32,
            topk_proposals=8, num_propagated=8, depth_num=32, max_decode=16,
            dn_max_gt=4,
            decoder=DecoderConfig(embed_dims=64, num_heads=2, num_layers=2,
                                  feedforward_channels=128)),
        focal=FocalHeadConfig(num_classes=10, in_channels=32, embed_dims=64),
        pad_shape=(64, 128), compute_dtype="float32")
    defaults.update(kw)
    return DetectorConfig(**defaults)


def stream_petr_vov_flash_800_bs2_seq_24e(**kw) -> DetectorConfig:
    """StreamPETR with VoVNet-99-eSE (V2-99) at 800x320 (arXiv 2303.11926;
    exiawsh/StreamPETR projects/configs/StreamPETR/
    stream_petr_vov_flash_800_bs2_seq_24e.py): VoVNetCP 'V-99-eSE' with
    frozen BatchNorm, out_features stage4 / stage5, CPFPN(in_channels=[768,
    1024], out_channels=256, num_outs=2), stride 16, position_level 0, and
    the head of the other StreamPETR presets, _head() field for field (644
    + 256 queries, a 1024-slot bank, 6 decoder layers of 256 wide with a
    2048 FFN, LID depth bins, the same ranges and code weights). Served in
    bf16, backbone and head, as the other served presets. Not carried: the
    published file's training settings that inference does not read (the
    decoder layers' with_cp, the data pipeline, the optimizer); the port
    trains and exports the ViT backbones only."""
    return _detector(VoVNetConfig("V-99-eSE", 3, ("stage4", "stage5")),
                     (320, 800), in_channels=(768, 1024), **kw)


def tiny_vov(**kw) -> DetectorConfig:
    """The V2-99 backbone and two-level neck on the tiny preset's head and
    pad shape (64x128), f32, for CPU tests."""
    return tiny_test_config(
        backbone=VoVNetConfig("V-99-eSE", 3, ("stage4", "stage5")),
        neck=CPFPNConfig(in_channels=(768, 1024), out_channels=32), **kw)


PRESETS = {
    "stream_petr_eva_vit_l": stream_petr_eva_vit_l,
    "stream_petr_eva_vit_l_1600": stream_petr_eva_vit_l_1600,
    "ToC3D_fast": toc3d_fast,
    "ToC3D_faster": toc3d_faster,
    "ToC3D_fast_1600": toc3d_fast_1600,
    "ToC3D_faster_1600": toc3d_faster_1600,
    "stream_petr_vit_b": stream_petr_vit_b,
    "ToC3D_vit_b_fast": toc3d_vit_b_fast,
    "ToC3D_vit_b_faster": toc3d_vit_b_faster,
    "tiny": tiny_test_config,
}

PORT_PRESETS = {
    "stream_petr_vov_flash_800_bs2_seq_24e":
        stream_petr_vov_flash_800_bs2_seq_24e,
    "tiny_vov": tiny_vov,
}


def apply_overrides(cfg, options):
    """Dotted-key config overrides, the reference's --cfg-options
    (presets.py:210-231): e.g. ["head.num_query=900",
    "backbone.token_ratio=(0.5,0.4,0.3)"]. Values are Python literals; a
    value that is not one stays a string."""
    import ast
    from dataclasses import replace

    def set_path(obj, path, value):
        key = path[0]
        if len(path) == 1:
            return replace(obj, **{key: value})
        child = getattr(obj, key)
        return replace(obj, **{key: set_path(child, path[1:], value)})

    for opt in options or ():
        key, _, raw = opt.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = set_path(cfg, key.strip().split("."), value)
    return cfg


def get_config(name: str, **kw) -> DetectorConfig:
    """A preset by name (PRESETS or PORT_PRESETS), or a speed-sweep name
    such as ToC3D_ratio543 or ToC3D_ratio543_1600 (presets.py:234-245)."""
    if name in PRESETS:
        return PRESETS[name](**kw)
    if name in PORT_PRESETS:
        return PORT_PRESETS[name](**kw)
    if name.startswith("ToC3D_ratio"):
        digits = name[len("ToC3D_ratio"):]
        res1600 = digits.endswith("_1600")
        digits = digits.replace("_1600", "")
        if len(digits) != 3 or not digits.isdigit():
            raise KeyError(f"unknown ratio-sweep name {name!r}")
        return toc3d_ratio_sweep(int(digits[0]), int(digits[1]),
                                 int(digits[2]), res1600=res1600, **kw)
    raise KeyError(f"unknown preset {name!r}; have "
                   f"{sorted(PRESETS) + sorted(PORT_PRESETS)}")


def served_in_bf16(cfg: DetectorConfig) -> DetectorConfig:
    """``cfg`` with the backbone and head in bf16, as the card serves an f32
    config such as ``tiny``: the kernels take bf16 activations."""
    from dataclasses import replace
    return replace(cfg, compute_dtype="bfloat16", head=replace(
        cfg.head, compute_dtype="bfloat16"))
