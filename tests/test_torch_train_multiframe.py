"""The port's multi-frame training losses (runtime/train.py ::
compute_losses_multiframe) against the JAX package's
(toc3d_tpu/runtime/train.py:265-313; tests/test_train.py:176) on the CPU in
f32 at the ``tiny`` preset, every draw of each frame handed across from
JAX's key tree (tests/test_torch_train_step.jax_noise). Each loss and the
total within 1e-4 relative."""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu.configs import get_config as jax_get_config
from toc3d_tpu.core import assigner as jax_assigner
from toc3d_tpu.models.detector import init_detector
from toc3d_tpu.runtime import train as jt

from toc3d_tpu_torch.configs import get_config
from toc3d_tpu_torch.convert import params_from_jax
from toc3d_tpu_torch.models.detector import build_detector
from toc3d_tpu_torch.runtime import train as tt

from test_torch_train_step import jax_noise, make_batch, rel_close


def test_multiframe_losses_match_jax():
    """compute_losses_multiframe over T = 2 frames (test_train.py:176):
    frame 0 streams the bank without losses, frame 1 gives the losses,
    keyed frame_1_*; JAX's per-frame keys split from one rng."""
    jcfg, tcfg = jax_get_config("tiny"), get_config("tiny")
    params = jax.jit(lambda k: init_detector(k, jcfg))(jax.random.PRNGKey(4))
    rng = np.random.RandomState(5)
    frames = [make_batch(rng, 1, 2, *jcfg.pad_shape) for _ in range(2)]
    frames[1]["prev_exists"][:] = 1.0
    batch = {k: np.stack([f[k] for f in frames], axis=1) for k in frames[0]}
    key = jax.random.PRNGKey(6)
    memory = jt.init_memory(1, jcfg.head)
    jax_assigner.set_default_impl("callback")
    try:
        total, (losses, _) = jax.jit(
            lambda p, m, bt, k: jt.compute_losses_multiframe(
                p, jcfg, m, bt, k))(params, memory,
                                    jax.tree_util.tree_map(jnp.asarray,
                                                           batch), key)
    finally:
        jax_assigner.set_default_impl(None)
    keys, noises = key, []
    for _ in range(2):
        keys, k = jax.random.split(keys)
        noises.append(jax_noise(jcfg, k, 1, 2))
    model = build_detector(tcfg, device="cpu", state_dict=params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    tb, _ = tt.batch_to_device(batch, "cpu")
    ttotal, (tlosses, tmem) = tt.compute_losses_multiframe(
        model, tt.init_memory(1, tcfg.head, "cpu"), tb, noises,
        steady=[False, True])
    assert set(tlosses) == set(losses)
    assert all(k.startswith("frame_1_") for k in tlosses)
    for k in losses:
        rel_close(float(tlosses[k].detach()), float(losses[k]), 1e-4, k)
    rel_close(float(ttotal.detach()), float(total), 1e-4, "total")
