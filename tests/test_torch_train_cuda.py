"""Training on the card at small shapes: the autograd Functions of kernels
A, B, C and D (ops/trainable.py, ops/cuda/cross_attn.FlashAttentionFn)
at edge cases the full-width phase_train of chip_smoke.py does not reach
(a ragged map whose windows are zero-padded, C at ws 16 / .5 with the
training keep count k 128 on a padded 20 x 20 map, C without the
representative token, head dim 32 and 64), each forward against its
kernel's plain version and its gradients against autograd through the
model path; and the tiny preset's train step in bf16 on the card (finite
losses, the launches a step, no launch from the backward).

Every test needs a CUDA card and skips without one. This file imports no
JAX (run it with ``--noconftest`` on a host without JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py -q

Tolerance: the kernel bounds of chip_smoke.py, max |err| <= 2^-5 max |ref|
and mean |err| <= 2^-6 mean |ref|, for the forward against the plain
version and for each gradient against the model path's.
"""
import numpy as np
import pytest
import torch

from toc3d_tpu_torch.models.eva_vit import Block, EVAViTConfig
from toc3d_tpu_torch.ops import trainable
from toc3d_tpu_torch.ops.cuda import cross_attn, vit_block
from toc3d_tpu_torch.ops.rope import build_rope_table

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref):
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(err).all()
    assert err.max().item() <= 2.0 ** -5 * ref.float().abs().max().item()
    assert err.mean().item() <= 2.0 ** -6 * ref.float().abs().mean().item()


def _block(c, heads, seed, dev):
    blk = Block(EVAViTConfig(embed_dim=c, num_heads=heads, mlp_ratio=2.0))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.05 if p.dim() > 1 else 0.1))
            if name.endswith(("norm1.weight", "norm2.weight",
                              "ffn_ln.weight")):
                p.add_(1.0)
    return blk.to(dev)


def _rope(c, heads, ws, dev):
    return tuple(torch.from_numpy(t).to(dev)
                 for t in build_rope_table(c // heads // 2, ws, ws))


def _grads(out, inputs, g):
    return torch.autograd.grad(out, inputs, g, allow_unused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,heads", [((8, 12), 64, 2), ((7, 11), 64, 1),
                                        ((8, 8), 64, 2)])
def test_full_block_fn_on_card(dev, hw, c, heads):
    ws = 4
    blk = _block(c, heads, 1, dev)
    rope = _rope(c, heads, ws, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn(2, *hw, c, device=dev, generator=g) * 0.5).to(BF) \
        .requires_grad_(True)
    gy = torch.randn(2, *hw, c, device=dev, generator=g).to(BF)
    before = vit_block.fused_full_block.launches
    out = trainable.trainable_full_block(blk, x, heads, ws, rope)
    assert vit_block.fused_full_block.launches == before + 1
    wts = vit_block.pack_block_weights(blk, heads, BF)
    _close(out, vit_block.full_block_plain(wts, x.detach(), heads, ws, rope))
    ins = [x] + list(blk.parameters())
    got = _grads(out, ins, gy)
    assert vit_block.fused_full_block.launches == before + 1
    ref = _grads(trainable.full_block_model(blk, x, heads, ws, rope), ins,
                 gy)
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,ws,ratio,use_rep", [
    ((20, 20), 64, 16, 0.5, True), ((8, 8), 64, 4, 0.5, False),
    ((7, 10), 64, 4, 0.3, True)])
def test_compressed_block_fn_on_card(dev, hw, c, ws, ratio, use_rep):
    """At ws 16 / .5 the plan keeps 128 (training: no MXU alignment) and
    the window attention sees 129 rows."""
    heads = 2
    blk = _block(c, heads, 3, dev)
    rope = _rope(c, heads, ws, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    b = 2
    x = (torch.randn(b, *hw, c, device=dev, generator=g) * 0.5).to(BF) \
        .requires_grad_(True)
    s = torch.log(torch.rand(b, hw[0] * hw[1], device=dev, generator=g)
                  * 0.9 + 0.05).to(BF).requires_grad_(True)
    gy = torch.randn(b, *hw, c, device=dev, generator=g).to(BF)
    plan = vit_block.compress_plan(s.detach(), b, *hw, ws, ratio, use_rep,
                                   align_k=False)
    if (ws, ratio) == (16, 0.5):
        assert plan.k == 128
    out = trainable.trainable_compressed_block(blk, x, s, heads, ws, ratio,
                                               rope, use_rep, True)
    wts = vit_block.pack_block_weights(blk, heads, BF)
    _close(out, vit_block.compressed_block_plain(wts, x.detach(), plan,
                                                 heads, ws, rope))
    ins = [x, s] + list(blk.parameters())
    got = _grads(out, ins, gy)
    ref = _grads(trainable.compressed_block_model(blk, x, s, heads, ws, rope,
                                                  plan), ins, gy)
    for a, b_ in zip(got, ref):
        assert (a is None) == (b_ is None)
        if a is not None:
            _close(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,kv,c,heads", [(100, 257, 256, 8),
                                           (64, 1000, 128, 2)])
def test_flash_fn_on_card(dev, nq, kv, c, heads):
    g = torch.Generator(device=dev).manual_seed(5)
    q = (torch.randn(2, nq, c, device=dev, generator=g)
         * (c // heads) ** -0.5).to(BF).requires_grad_(True)
    k = torch.randn(2, kv, c, device=dev, generator=g).to(BF) \
        .requires_grad_(True)
    v = torch.randn(2, kv, c, device=dev, generator=g).to(BF) \
        .requires_grad_(True)
    gy = torch.randn(2, nq, c, device=dev, generator=g).to(BF)
    out = cross_attn.flash_attention(q, k, v, heads)
    _close(out, cross_attn.flash_attention_plain(q.detach(), k.detach(),
                                                 v.detach(), heads))
    got = _grads(out, [q, k, v], gy)
    ref = _grads(cross_attn.attention_core_model(q, k, v, heads), [q, k, v],
                 gy)
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.cuda
def test_patch_embed_fn_on_card(dev):
    conv = torch.nn.Conv2d(3, 64, 16, stride=16).to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(2, 64, 128, 3, device=dev, generator=g).to(BF)
    gy = torch.randn(2, 4, 8, 64, device=dev, generator=g).to(BF)
    out = trainable.trainable_patch_embed(conv, x, 16)
    _close(out, trainable.patch_embed_model(conv, x, 16))
    ins = [conv.weight, conv.bias]
    for a, b in zip(_grads(out, ins, gy),
                    _grads(trainable.patch_embed_model(conv, x, 16), ins,
                           gy)):
        _close(a, b)


@pytest.mark.cuda
def test_tiny_train_step_on_card(dev):
    """The tiny preset in bf16, two steps on the card: finite losses, the
    launches of one step (A 1, B 2: blocks 0 and 1, no stochastic depth
    at tiny, C 2: blocks 2 and 3, G 16, LN 12, D 0: the decoder has
    dropout, the auction 3: the two decoder layers' costs and the 2D
    head's, the card's default matcher, the window attention's one-pass
    body 4: one a B or C, the packed convolutions 0: training runs the neck
    on per-call casts, the QKV epilogue 4: one a B or C), the parameters
    moved, no skip."""
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.configs.presets import served_in_bf16
    from toc3d_tpu_torch.models.detector import build_detector
    from toc3d_tpu_torch.ops.cuda import counted_wrappers
    from toc3d_tpu_torch.runtime import train as tr
    cfg = served_in_bf16(get_config("tiny"))
    model = build_detector(cfg, device=dev, seed=0)
    tx = tr.make_optimizer(model, total_iters=10)
    state = tr.init_train_state(model, tx, 2)
    step = tr.make_train_step(tx)
    rng = np.random.RandomState(0)
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    intr = eye.copy()
    intr[..., 0, 0] = intr[..., 1, 1] = 1.2e3
    boxes = rng.randn(2, 4, 9).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1.0
    host = {
        "img": rng.randn(2, 2, 64, 128, 3).astype(np.float32),
        "intrinsics": intr, "img2lidar": eye,
        "timestamp": np.full((2,), 0.5, np.float32),
        "ego_pose": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        "ego_pose_inv": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        "prev_exists": np.zeros((2,), np.float32),
        "gt_bboxes_3d": boxes, "gt_labels_3d": rng.randint(0, 10, (2, 4)),
        "gt_valid_3d": np.ones((2, 4), bool),
        "gt_bboxes_2d": np.sort(rng.rand(2, 2, 4, 2, 2).astype(np.float32)
                                * 30, axis=-2).reshape(2, 2, 4, 4),
        "gt_labels_2d": rng.randint(0, 10, (2, 2, 4)),
        "gt_centers_2d": rng.rand(2, 2, 4, 2).astype(np.float32) * 30,
        "gt_valid_2d": np.ones((2, 2, 4), bool)}
    batch, _ = tr.batch_to_device(host, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    wrappers = counted_wrappers()
    for i in range(2):
        noise = tr.draw_train_noise(cfg, 2, 2, gen, dev)
        for f in wrappers.values():
            f.launches = 0
        state, m = step(state, batch, noise, steady=i > 0)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in wrappers.items()}
        assert counts == {"A": 1, "B": 2, "C": 2, "D": 0, "B8": 0, "C8": 0,
                          "H8": 0, "G": 16, "G8": 0, "LN": 12, "AU": 3,
                          "W1": 4, "W2": 0, "conv": 0, "qkv": 4}, counts
        assert all(np.isfinite(float(v)) for v in m.values())
        assert int(m["nonfinite_skips"]) == 0
        batch["prev_exists"][:] = 1.0
    moved = sum(not torch.equal(v, before[k])
                for k, v in model.state_dict().items())
    assert moved > 0.9 * len(before)
