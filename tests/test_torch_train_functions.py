"""The trainable kernels of the port (ops/trainable.py: A, B and C as
autograd Functions; ops/cuda/cross_attn.FlashAttentionFn: D) against
jax.vjp of the JAX package's XLA block at the same point, as
tests/test_pallas.py:158 and tests/test_flash_attn.py:42 hold JAX's own
custom VJPs. On the CPU each Function's forward is its kernel's plain
version and its backward autograd through the model path.

Forward within 2e-5; gradients within 1e-4 relative (elementwise rtol 1e-4,
atol 1e-4 of the reference's largest magnitude). C is checked with the
training keep count (no MXU alignment: k 128 at ws 16, ratio .5) and its
gradient in the scores. Also here: stochastic depth and the decoder's
dropout, each given JAX's own masks.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from toc3d_tpu.models.eva_vit import (EVAViTConfig, _block_forward_xla,
                                      _patch_embed_conv, init_block)
from toc3d_tpu.models.toc3d_vit import ToC3DViTConfig, toc3d_block_forward
from toc3d_tpu.ops.attention import init_mha, mha as jax_mha
from toc3d_tpu.ops.pallas.cross_attn import _xla_core
from toc3d_tpu.ops.rope import build_rope_table

from toc3d_tpu_torch.convert import block_state_from_jax, _Out
from toc3d_tpu_torch.models.eva_vit import Block
from toc3d_tpu_torch.models.eva_vit import EVAViTConfig as TEVAViTConfig
from toc3d_tpu_torch.ops.attention import MultiheadAttention, mha
from toc3d_tpu_torch.ops.cuda.cross_attn import flash_attention
from toc3d_tpu_torch.ops.trainable import (full_block_model,
                                           trainable_compressed_block,
                                           trainable_full_block,
                                           trainable_patch_embed)

FWD = dict(atol=2e-5, rtol=2e-5)


def jax_vjp(f, primals, g):
    """jax.vjp of f at ``primals`` applied to g, as one jitted program:
    (f's output, the cotangents of the primals)."""
    def run(primals, g):
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(g)
    return jax.jit(run)(primals, g)


def _close_grad(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=name)


def _jax_block(seed, c, hidden, heads):
    cfg = EVAViTConfig(embed_dim=c, num_heads=heads, mlp_ratio=hidden / c)
    p = init_block(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)

    def bump(d):
        return {k: (bump(v) if isinstance(v, dict) else jnp.asarray(
            np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.05))
            for k, v in d.items()}
    return bump(p)


def _torch_block(p, c, hidden, heads):
    blk = Block(TEVAViTConfig(embed_dim=c, num_heads=heads,
                              mlp_ratio=hidden / c))
    blk.load_state_dict(block_state_from_jax(
        jax.tree_util.tree_map(np.asarray, p)))
    return blk


def _param_grads(blk):
    return {n: p.grad.numpy() for n, p in blk.named_parameters()}


def _check_block_grads(blk, jgrad_tree):
    want = block_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jgrad_tree))
    got = _param_grads(blk)
    assert set(got) == set(want)
    for n in sorted(want):
        _close_grad(got[n], want[n].numpy(), n)


def _tables(c, heads, ws):
    cos, sin = build_rope_table(c // heads // 2, ws, ws)
    return (cos, sin), (torch.from_numpy(cos), torch.from_numpy(sin))


def test_patch_embed_fn_matches_jax_vjp():
    """A: the conv path's vjp (eva_vit.py:125-143) in the weight, the bias
    and the image."""
    rng = np.random.RandomState(0)
    b, h, w, ps, c = 2, 32, 64, 16, 32
    x = rng.randn(b, h, w, 3).astype(np.float32)
    wj = (rng.randn(ps, ps, 3, c) * 0.05).astype(np.float32)
    bj = rng.randn(c).astype(np.float32)
    g = rng.randn(b, h // ps, w // ps, c).astype(np.float32)
    p = {"w": jnp.asarray(wj), "b": jnp.asarray(bj)}
    out_j, (gp, gx) = jax_vjp(lambda p_, x_: _patch_embed_conv(p_, x_, ps),
                              (p, jnp.asarray(x)), jnp.asarray(g))
    conv = torch.nn.Conv2d(3, c, ps, stride=ps)
    o = _Out()
    o.conv("c", {"w": wj, "b": bj})
    conv.load_state_dict({"weight": o.sd["c.weight"],
                          "bias": o.sd["c.bias"]})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = trainable_patch_embed(conv, xt, ps)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    gw = _Out()
    gw.conv("c", {"w": np.asarray(gp["w"]), "b": np.asarray(gp["b"])})
    _close_grad(conv.weight.grad.numpy(), gw.sd["c.weight"].numpy(), "w")
    _close_grad(conv.bias.grad.numpy(), gw.sd["c.bias"].numpy(), "b")
    _close_grad(xt.grad.numpy(), np.asarray(gx), "x")


@pytest.mark.parametrize("rope", [True, False])
def test_full_block_fn_matches_jax_vjp(rope):
    """B against jax.vjp of _block_forward_xla (eva_vit.py:269)."""
    c, hidden, heads, ws = 32, 64, 2, 4
    p = _jax_block(0, c, hidden, heads)
    blk = _torch_block(p, c, hidden, heads)
    cfg = EVAViTConfig(embed_dim=c, num_heads=heads, mlp_ratio=hidden / c,
                       window_size=ws)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    g = rng.randn(2, 8, 8, c).astype(np.float32)
    jt, tt = _tables(c, heads, ws)
    jt, tt = (jt, tt) if rope else (None, None)
    out_j, (gp, gx) = jax_vjp(
        lambda p_, x_: _block_forward_xla(p_, x_, cfg, ws, jt),
        (p, jnp.asarray(x)), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = trainable_full_block(blk, xt, heads, ws, tt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    _close_grad(xt.grad.numpy(), np.asarray(gx), "x")
    _check_block_grads(blk, gp)


@pytest.mark.parametrize("hw,c,ws,ratio,use_rep", [
    ((8, 8), 32, 4, 0.5, True), ((8, 8), 32, 4, 0.5, False),
    ((16, 16), 64, 16, 0.5, True), ((16, 16), 64, 16, 0.4, True)])
def test_compressed_block_fn_matches_jax_vjp(hw, c, ws, ratio, use_rep):
    """C against jax.vjp of toc3d_block_forward (toc3d_vit.py:113-177) with
    the training keep count (mxu_align_k off): at ws 16 / .5 that is k 128
    and 129 attended rows; gradients in the parameters, x and the
    scores."""
    hidden, heads = 2 * c, 2
    p = _jax_block(2, c, hidden, heads)
    blk = _torch_block(p, c, hidden, heads)
    tcfg = ToC3DViTConfig(embed_dim=c, num_heads=heads, mlp_ratio=2.0,
                          window_size=ws, pruning_loc=(0,),
                          token_ratio=(ratio,), global_attn_indexes=(9,),
                          use_represent_tokens=use_rep, rope_acc=True,
                          mxu_align_k=False)
    rng = np.random.RandomState(3)
    b = 2 if ws < 16 else 1
    x = rng.randn(b, *hw, c).astype(np.float32)
    scores = np.log(rng.rand(b, hw[0] * hw[1]).astype(np.float32) * 0.9
                    + 0.05)
    g = rng.randn(b, *hw, c).astype(np.float32)
    jt, tt = _tables(c, heads, ws)
    out_j, (gp, gx, gs) = jax_vjp(
        lambda p_, x_, s_: toc3d_block_forward(p_, x_, s_, tcfg, ws, ratio,
                                               jt),
        (p, jnp.asarray(x), jnp.asarray(scores)), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(scores).requires_grad_(True)
    out = trainable_compressed_block(blk, xt, st, heads, ws, ratio, tt,
                                     use_rep, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    _close_grad(xt.grad.numpy(), np.asarray(gx), "x")
    # without the representative token the scores only route (no gradient)
    gst = np.zeros_like(scores) if st.grad is None else st.grad.numpy()
    _close_grad(gst, np.asarray(gs), "scores")
    assert (np.abs(gst).max() > 0) == use_rep
    _check_block_grads(blk, gp)


def test_flash_fn_matches_jax_vjp():
    """D against jax.vjp of _xla_core (cross_attn.py:167-177)."""
    rng = np.random.RandomState(1)
    b, q, kv, c, h = 1, 24, 200, 64, 2
    qa = (rng.randn(b, q, c) * 0.3).astype(np.float32)
    ka = (rng.randn(b, kv, c) * 0.3).astype(np.float32)
    va = rng.randn(b, kv, c).astype(np.float32)
    g = rng.randn(b, q, c).astype(np.float32)
    out_j, grads_j = jax_vjp(lambda a, b_, c_: _xla_core(a, b_, c_, h),
                             (jnp.asarray(qa), jnp.asarray(ka),
                              jnp.asarray(va)), jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (qa, ka, va)]
    out = flash_attention(*ts, h)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    for t, gj, n in zip(ts, grads_j, "qkv"):
        _close_grad(t.grad.numpy(), np.asarray(gj), n)


def test_drop_path_matches_jax_given_its_masks():
    """A full block with stochastic depth (the model path, eva_vit.py:
    251-288) given JAX's two keep masks, forward and vjp."""
    c, hidden, heads, ws, rate = 32, 64, 2, 4, 0.3
    p = _jax_block(5, c, hidden, heads)
    blk = _torch_block(p, c, hidden, heads)
    cfg = EVAViTConfig(embed_dim=c, num_heads=heads, mlp_ratio=hidden / c,
                       window_size=ws)
    rng = np.random.RandomState(6)
    b = 8
    x = rng.randn(b, 8, 8, c).astype(np.float32)
    g = rng.randn(b, 8, 8, c).astype(np.float32)
    key = jax.random.PRNGKey(11)
    keeps = [np.asarray(jax.random.bernoulli(jax.random.fold_in(key, j),
                                             1 - rate, (b, 1, 1, 1)))
             .reshape(b) for j in (0, 1)]
    assert not keeps[0].all() or not keeps[1].all()
    jt, tt = _tables(c, heads, ws)
    out_j, (gp, gx) = jax_vjp(lambda p_, x_: _block_forward_xla(
        p_, x_, cfg, ws, jt, rate, key), (p, jnp.asarray(x)),
        jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = full_block_model(blk, xt, heads, ws, tt,
                           tuple(torch.from_numpy(k.copy()) for k in keeps),
                           rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    _close_grad(xt.grad.numpy(), np.asarray(gx), "x")
    _check_block_grads(blk, gp)


@pytest.mark.parametrize("masked", [True, False])
def test_mha_train_dropout_matches_jax_given_its_mask(masked):
    """The decoder's attention in training (attention.py:132-208) with an
    attention mask and JAX's own dropout mask of the probabilities."""
    rng = np.random.RandomState(7)
    b, q, kv, c, h, rate = 2, 12, 20, 32, 2, 0.1
    pj = init_mha(jax.random.PRNGKey(3), c, h)
    pj = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32)
                                  * 0.05), pj)
    qa, ka, va = (rng.randn(b, n, c).astype(np.float32)
                  for n in (q, kv, kv))
    mask = rng.rand(q, kv) < 0.3 if masked else None
    key = jax.random.PRNGKey(9)
    keep = np.asarray(jax.random.bernoulli(key, 1 - rate, (b, h, q, kv)))
    g = rng.randn(b, q, c).astype(np.float32)

    def f(p_, a, k_, v_):
        return jax_mha(p_, a, k_, v_, h,
                       attn_mask=None if mask is None else jnp.asarray(mask),
                       dropout_rate=rate, dropout_rng=key)[0]
    out_j, (gp, gq, gk, gv) = jax_vjp(
        f, (pj, jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va)),
        jnp.asarray(g))
    attn = MultiheadAttention(c, h)
    o = _Out()
    o.mha("m", jax.tree_util.tree_map(np.asarray, pj))
    attn.load_state_dict({k[2:]: v for k, v in o.sd.items()})
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (qa, ka, va)]
    out = mha(attn, *ts, h,
              attn_mask=None if mask is None else torch.from_numpy(mask),
              drop_mask=torch.from_numpy(keep.copy()), rate=rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    out.backward(torch.from_numpy(g))
    for t, gj, n in zip(ts, (gq, gk, gv), "qkv"):
        _close_grad(t.grad.numpy(), np.asarray(gj), n)
    gw = _Out()
    gw.mha("m", jax.tree_util.tree_map(np.asarray, gp))
    for n, prm in attn.named_parameters():
        _close_grad(prm.grad.numpy(), gw.sd["m." + n].numpy(), n)
