"""The port's public-backbone warm start
(toc3d_tpu_torch/runtime/checkpoint.load_backbone_pretrained) against the
JAX package's (toc3d_tpu/runtime/checkpoint.py:311-365) on seeded synthetic
EVA-02 checkpoints in the four namings of PRETRAINED_PREFIX_REWRITES: bare
(MAE), ``image_encoder.`` (SAM), ``backbone.net.`` (ViTDet) and
``module.``, and ``module.image_encoder.``, which the rewrites, applied in
order, leave under ``img_backbone.image_encoder.`` (nothing loads). Some
blocks lack a key JAX's convert_eva_block reads (that block stays at its
init) or a linear's bias (the block loads with a zero bias: JAX's linear
without one adds none); some checkpoints have no patch embedding, some a
``pos_embed`` of another grid. Checked: the reports list for list, every
loaded block equal to convert.block_state_from_jax of JAX's merged block,
the patch embedding and pos_embed equal to JAX's, unloaded blocks at their
init, the weight key changed and the weight packs rebuilt, and the merged
backbone's forward against JAX's at 1e-5 (the other grid resampled).
"""
import jax
import numpy as np
import pytest
import torch

from toc3d_tpu.models.eva_vit import EVAViTConfig as JEVAViTConfig
from toc3d_tpu.models.eva_vit import eva_vit_forward as jax_forward
from toc3d_tpu.models.eva_vit import init_eva_vit
from toc3d_tpu.runtime.checkpoint import \
    load_backbone_pretrained as jax_load_pretrained

from toc3d_tpu_torch.convert import block_state_from_jax
from toc3d_tpu_torch.models.eva_vit import EVAViT, EVAViTConfig
from toc3d_tpu_torch.models.eva_vit import eva_vit_forward
from toc3d_tpu_torch.ops.cuda import param_key, vit_block
from toc3d_tpu_torch.runtime.checkpoint import (PRETRAINED_PREFIX_REWRITES,
                                                load_backbone_pretrained)

VIT = dict(img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=2,
           window_size=4, global_window_size=4, global_attn_indexes=(1, 3),
           pretrain_img_size=32)
C, HID, DEPTH = 32, int(32 * (4 * 2 / 3)), 4

# name -> shape of every key an EVA-02 block holds (reference naming)
BLOCK = {"norm1.weight": (C,), "norm1.bias": (C,),
         "attn.q_proj.weight": (C, C), "attn.q_bias": (C,),
         "attn.k_proj.weight": (C, C), "attn.v_proj.weight": (C, C),
         "attn.v_bias": (C,), "attn.proj.weight": (C, C),
         "attn.proj.bias": (C,), "norm2.weight": (C,), "norm2.bias": (C,),
         "mlp.w1.weight": (HID, C), "mlp.w1.bias": (HID,),
         "mlp.w2.weight": (HID, C), "mlp.w2.bias": (HID,),
         "mlp.w3.weight": (C, HID), "mlp.w3.bias": (C,),
         "mlp.ffn_ln.weight": (HID,), "mlp.ffn_ln.bias": (HID,)}

# naming -> (prefix, {block: key left out}, patch embedding, pos_embed grid
# or None, values as torch tensors)
CASES = {
    "mae": ("", {}, True, 2, False),
    "sam": ("image_encoder.", {1: "attn.v_bias"}, False, None, True),
    "vitdet": ("backbone.net.", {2: "mlp.w2.bias"}, True, 3, False),
    "module": ("module.", {0: "norm2.weight", 3: "attn.k_proj.weight"},
               True, None, True),
    "module_sam": ("module.image_encoder.", {}, True, 2, False),
}


def synthetic_checkpoint(seed, prefix, drop, patch, grid, as_tensor):
    """A seeded EVA-02 backbone state dict (plus keys of a classifier and a
    neck that the merge ignores)."""
    rng = np.random.RandomState(seed)

    def draw(key, shape):
        v = rng.randn(*shape).astype(np.float32)
        if len(shape) > 1:
            v *= 0.05
        elif key.endswith(("norm1.weight", "norm2.weight", "ffn_ln.weight")):
            v = 1.0 + 0.1 * v
        else:
            v *= 0.1
        return v
    sd = {}
    if patch:
        sd["patch_embed.proj.weight"] = draw("w", (C, 3, 16, 16))
        sd["patch_embed.proj.bias"] = draw("b", (C,))
    if grid:
        sd["pos_embed"] = draw("w", (1, grid * grid + 1, C))
    for i in range(DEPTH):
        for k, shape in BLOCK.items():
            if drop.get(i) != k:
                sd[f"blocks.{i}.{k}"] = draw(k, shape)
    sd["norm.weight"] = draw("norm.weight", (C,))
    sd["head.weight"] = draw("w", (10, C))
    sd["neck.0.weight"] = draw("w", (C, C, 1, 1))
    sd = {prefix + k: v for k, v in sd.items()}
    return {k: torch.from_numpy(v) for k, v in sd.items()} if as_tensor \
        else sd


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _backbone_state(bb):
    """The port's backbone state dict from JAX's backbone params."""
    sd = {"patch_embed.proj.weight": np.transpose(
        np.asarray(bb["patch_embed"]["w"]), (3, 2, 0, 1)),
        "patch_embed.proj.bias": np.asarray(bb["patch_embed"]["b"]),
        "pos_embed": np.asarray(bb["pos_embed"])}
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    for i, blk in enumerate(bb["blocks"]):
        sd.update({f"blocks.{i}.{k}": v
                   for k, v in block_state_from_jax(_np(blk)).items()})
    return sd


class Holder(torch.nn.Module):
    """The part of a detector the merge reads: ``img_backbone``."""

    def __init__(self, bb):
        super().__init__()
        self.img_backbone = bb


@pytest.fixture(scope="module")
def init():
    """JAX's backbone params at init and the port's backbone with the same
    values."""
    bb = init_eva_vit(jax.random.PRNGKey(0), JEVAViTConfig(**VIT))
    return bb, _backbone_state(bb)


def _merged(init, name):
    bb0, sd0 = init
    prefix, drop, patch, grid, as_tensor = CASES[name]
    ck = synthetic_checkpoint(7, prefix, drop, patch, grid, as_tensor)
    jparams, jreport = jax_load_pretrained({"img_backbone": bb0}, ck, DEPTH)
    model = Holder(EVAViT(EVAViTConfig(**VIT)))
    model.img_backbone.load_state_dict(sd0)
    report = load_backbone_pretrained(model, ck)
    return model, report, jparams["img_backbone"], jreport


def test_rewrites_are_jax():
    from toc3d_tpu.runtime.checkpoint import PRETRAINED_PREFIX_REWRITES as J
    assert PRETRAINED_PREFIX_REWRITES == J


@pytest.mark.parametrize("name", list(CASES))
def test_merge_equals_jax(init, name):
    model, report, jbb, jreport = _merged(init, name)
    assert report == jreport
    assert "pos_embed" not in report["missing"]
    assert len(report["loaded"]) + len(report["missing"]) == DEPTH + 1 + (
        "pos_embed" in report["loaded"])
    _, sd0 = init
    got = {k: v for k, v in model.img_backbone.state_dict().items()}
    for i in range(DEPTH):
        pre = f"blocks.{i}."
        if f"blocks.{i}" in report["loaded"]:
            want = block_state_from_jax(_np(jbb["blocks"][i]))
            for k in BLOCK:
                if k in want:
                    assert torch.equal(got[pre + k], want[k]), (i, k)
                else:   # a bias the checkpoint lacks: JAX's linear has none
                    assert not got[pre + k].any(), (i, k)
        else:
            for k in BLOCK:
                assert torch.equal(got[pre + k], sd0[pre + k]), (i, k)
    pe = _np(jbb["patch_embed"])
    assert torch.equal(got["patch_embed.proj.weight"], torch.from_numpy(
        np.ascontiguousarray(np.transpose(pe["w"], (3, 2, 0, 1)))))
    assert torch.equal(got["patch_embed.proj.bias"],
                       torch.from_numpy(np.array(pe["b"])))
    assert torch.equal(got["pos_embed"],
                       torch.from_numpy(np.array(jbb["pos_embed"])))
    if name == "module_sam":    # all under img_backbone.image_encoder.
        assert report["loaded"] == []


def test_merge_changes_weight_key_and_packs(init):
    """The copies change param_key, so a cached block pack is rebuilt from
    the merged weights; a checkpoint that loads nothing leaves both."""
    _, sd0 = init
    model = Holder(EVAViT(EVAViTConfig(**VIT)))
    model.img_backbone.load_state_dict(sd0)
    blk = model.img_backbone.blocks[2]
    key, pack = param_key(model), vit_block.pack_block_weights(
        blk, 2, torch.float32)
    load_backbone_pretrained(model, synthetic_checkpoint(
        7, *CASES["module_sam"][:4], False))
    assert model.img_backbone.pos_embed.shape == (1, 5, C)
    assert param_key(model) == key
    assert vit_block.pack_block_weights(blk, 2, torch.float32) is pack
    load_backbone_pretrained(model, synthetic_checkpoint(
        7, *CASES["vitdet"][:4], False))
    assert param_key(model) != key
    new = vit_block.pack_block_weights(blk, 2, torch.float32)
    assert new is not pack
    assert not torch.equal(new.wqkv, pack.wqkv)


def test_other_grid_pos_embed_forward_equals_jax(init):
    """A 3 x 3 (+ cls) pos_embed, resampled to the 4 x 4 map by the forward
    of both packages: features at 1e-5."""
    model, report, jbb, _ = _merged(init, "vitdet")
    assert "pos_embed" in report["loaded"]
    assert model.img_backbone.pos_embed.shape == (1, 10, C)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jax_forward(p, x, JEVAViTConfig(**VIT)))(
        jbb, x)
    with torch.no_grad():
        got = eva_vit_forward(model.img_backbone, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the same backbone with its init pos_embed computes something else
    _, sd0 = init
    fresh = EVAViT(EVAViTConfig(**VIT))
    fresh.load_state_dict(sd0)
    with torch.no_grad():
        assert not torch.allclose(eva_vit_forward(fresh, torch.from_numpy(x)),
                                  got)
