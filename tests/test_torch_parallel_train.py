"""Data-parallel training of the port (parallel/mesh.py, runtime/train.py
with a process group) against the JAX package's step on the global batch,
on the CPU in f32 at the ``tiny`` preset with stochastic depth on, as
tests/test_torch_train_step.py runs one process.

JAX's ``make_train_step`` takes one step on a batch of 2 lanes in this
process, with its draws handed across (test_torch_train_step.jax_noise).
The lanes'
numbers of valid boxes differ, so a rank that normalized its losses by its
own counts would fail. Two spawned ranks of the port (gloo, rendezvous
through a FileStore in the test's directory, one thread each) take the same step at batch 1 a rank:
each keeps its lane of the batch and of the draws, the losses are
normalized by the counts summed over the ranks and the gradients averaged.
One launch of the two ranks also saves the train state, steps on, resumes
a fresh state from the file and steps again, and round-trips
runtime/eval.gather_results_multihost.

Tolerances, those of test_torch_train_step: the ranks' mean of every loss,
the total and grad_norm within 1e-4 relative; every gradient (read from
AdamW's first moment) within 1e-4 relative and 1e-4 of its tensor's
largest; the parameters after the update within 1e-5 but where the
gradient is rounding; the two ranks' parameters, moments and grad_norm
equal bit for bit; the resume exact.

Run as a script, this file is one rank (``_rank_main``): it imports
neither JAX nor the JAX package.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from toc3d_tpu_torch.configs import get_config  # noqa: E402
from toc3d_tpu_torch.runtime import train as tt  # noqa: E402

WORLD = 2
VIEWS = 2
RANK_TIMEOUT = 300   # seconds a rank may take; a hang fails the test


def _tiny():
    cfg = get_config("tiny")
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, drop_path_rate=0.1))


def _snapshot(state, tx, metrics=None):
    out = {"params": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
           "mu": dict(zip(tx.names, (m.clone() for m in
                                     state.opt_state["mu"]))),
           "nu": [m.clone() for m in state.opt_state["nu"]],
           "count": state.opt_state["count"].clone(),
           "notfinite": state.opt_state["notfinite"].clone(),
           "memory": [t.clone() for t in state.memory], "step": state.step}
    if metrics is not None:
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def _same(a, b):
    """Two snapshots equal bit for bit."""
    return (all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
            and all(torch.equal(v, b["mu"][k]) for k, v in a["mu"].items())
            and all(torch.equal(x, y) for x, y in zip(a["nu"], b["nu"]))
            and torch.equal(a["count"], b["count"])
            and torch.equal(a["notfinite"], b["notfinite"])
            and all(torch.equal(x, y) for x, y in zip(a["memory"],
                                                      b["memory"]))
            and a["step"] == b["step"])


def _rank_main(rank: int, world: int, work: str) -> None:
    """One rank: the DP step against JAX's inputs, save, a second step,
    resume into a fresh state, the same second step, the results' gather.
    Writes rank{rank}.pt into ``work``."""
    import torch.distributed as dist
    from toc3d_tpu_torch.models.detector import build_detector
    from toc3d_tpu_torch.parallel import mesh
    from toc3d_tpu_torch.runtime.checkpoint import (load_train_state,
                                                    save_train_state)
    from toc3d_tpu_torch.runtime.eval import gather_results_multihost

    torch.set_num_threads(1)
    mesh.init_distributed(f"file://{work}/store", world, rank, "cpu")
    group = dist.group.WORLD
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg = _tiny()
    lanes = mesh.local_lanes(2, group)

    def fresh(sd=None, seed=0):
        model = build_detector(cfg, device="cpu", state_dict=sd, seed=seed)
        tx = tt.make_optimizer(model, total_iters=100)
        state = tt.init_train_state(model, tx, 1)
        mesh.broadcast_train_state(model, state.opt_state, group)
        return state, tx

    def step(state, tx, t):
        batch, steady = tt.batch_to_device(
            mesh.shard_batch(inputs["batches"][t], group), "cpu")
        noise = tt.noise_lanes(inputs["noises"][t], lanes, VIEWS)
        return tt.make_train_step(tx, group=group)(state, batch, noise,
                                                   steady=steady)

    state, tx = fresh(inputs["state_dict"])
    state, metrics = step(state, tx, 0)
    out = {"first": _snapshot(state, tx, metrics)}
    path = save_train_state(state, tx, os.path.join(work, "iter_1.pth"),
                            group)
    state, _ = step(state, tx, 1)
    out["uninterrupted"] = _snapshot(state, tx)
    resumed, rtx = fresh(seed=3)
    resumed = load_train_state(path, resumed, rtx, group)
    out["loaded_bank_equal"] = all(torch.equal(a, b) for a, b in zip(
        resumed.memory, out["first"]["memory"]))
    resumed, _ = step(resumed, rtx, 1)
    out["resume_exact"] = _same(_snapshot(resumed, rtx),
                                out["uninterrupted"])

    results = {f"token-{rank}-{i}": [{"score": 0.5 + 0.125 * i,
                                       "rank": rank}]
               for i in range(3 + rank)}
    out["gathered"] = list(gather_results_multihost(results, group).items())
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def launch_ranks(script: str, world: int, work: str):
    """Spawn ``world`` ranks of ``script`` (each ``script rank world
    work``), bounded by RANK_TIMEOUT each; fail with a rank's output if it
    fails or hangs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world),
                               work], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's global-batch step, then the two ranks of the port."""
    import jax
    import jax.numpy as jnp
    from toc3d_tpu.configs import get_config as jax_get_config
    from toc3d_tpu.core import assigner as jax_assigner
    from toc3d_tpu.models.detector import init_detector
    from toc3d_tpu.runtime import train as jt
    from toc3d_tpu_torch.convert import params_from_jax
    from test_torch_train_step import (_with_droppath, jax_first_moment,
                                       jax_noise, make_batch)

    work = tmp_path_factory.mktemp("dp")
    jcfg = _with_droppath(jax_get_config("tiny"))
    tcfg = _tiny()
    params = jax.jit(lambda k: init_detector(k, jcfg))(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    batches = [make_batch(np.random.RandomState(s), 2, VIEWS,
                          *jcfg.pad_shape) for s in (0, 1)]
    # the lanes' counts differ (3 and 4 valid 3D boxes, 7 and 8 valid 2D
    # ones), so a rank that normalized by its own counts would be caught
    for bt in batches:
        bt["gt_valid_3d"][1, 3] = False
        bt["gt_valid_2d"][1, 0, 3] = False
    batches[1]["prev_exists"][:] = 1.0
    batches[1]["timestamp"][:] = 1.0
    key = jax.random.PRNGKey(1)
    tx = jt.make_optimizer(params, total_iters=100)
    state = jt.init_train_state(params, tx, 2, jcfg)
    jax_assigner.set_default_impl("callback")
    try:
        state, metrics = jax.jit(jt.make_train_step(jcfg, tx))(
            state, jax.tree_util.tree_map(jnp.asarray, batches[0]), key)
    finally:
        jax_assigner.set_default_impl(None)
    noises = [jax_noise(jcfg, key, 2, VIEWS),
              tt.draw_train_noise(tcfg, 2, VIEWS,
                                  torch.Generator().manual_seed(5), "cpu")]
    torch.save({"state_dict": params_from_jax(params_np, tcfg),
                "batches": batches, "noises": noises},
               work / "inputs.pt")
    launch_ranks(__file__, WORLD, str(work))
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(
        ranks=ranks, work=work, tcfg=tcfg,
        jax_metrics={k: float(v) for k, v in metrics.items()},
        jax_mu=jax_first_moment(state.opt_state, tcfg),
        jax_params=params_from_jax(jax.tree_util.tree_map(
            np.asarray, state.params), tcfg),
        before=params_from_jax(params_np, tcfg),
        lr0=float(tt.make_lr_schedule(total_iters=100)(0)))


def test_dp_losses_and_grad_norm_match_jax_global_batch(dp_run):
    """The ranks' mean of each loss (each rank's is W times its share of
    the global batch's) and grad_norm (the same on both ranks) against
    JAX's step on the batch of 2."""
    from test_torch_train_step import rel_close
    jm = dp_run["jax_metrics"]
    ms = [r["first"]["metrics"] for r in dp_run["ranks"]]
    assert set(ms[0]) == set(jm), set(ms[0]) ^ set(jm)
    for k in sorted(jm):
        rel_close(np.mean([m[k] for m in ms]), jm[k], 1e-4, k)
    assert ms[0]["grad_norm"] == ms[1]["grad_norm"]
    assert ms[0]["nonfinite_skips"] == 0 and "semantic_loss" in ms[0]
    # the lanes differ, so the ranks' shares do
    assert ms[0]["total_loss"] != ms[1]["total_loss"]


def test_dp_gradients_match_jax_global_batch(dp_run):
    """Every parameter's averaged gradient (AdamW's first moment / 0.1)
    against JAX's global-batch gradient, element by element."""
    want = {k: np.asarray(v, np.float64) / 0.1
            for k, v in dp_run["jax_mu"].items()}
    got = {k: v.double().numpy() / 0.1
           for k, v in dp_run["ranks"][0]["first"]["mu"].items()}
    assert set(got) == set(want)
    for k in sorted(want):
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    live = {k for k, v in want.items() if np.abs(v).max() > 0}
    assert len(live) > 0.8 * len(want), len(live)


def test_dp_updated_params_match_jax_global_batch(dp_run):
    """Within 1e-5 but where the gradient is rounding (at most 1e-6 of its
    tensor's largest on both sides), where the bound is the first AdamW
    step's 2 lr (1 + wd |p|), for at most 1e-4 of the elements
    (test_torch_train_step.test_train_step_updated_params_match_jax)."""
    want, before = dp_run["jax_params"], dp_run["before"]
    first = dp_run["ranks"][0]["first"]
    got, mu_t, mu_j = first["params"], first["mu"], dp_run["jax_mu"]
    assert set(got) == set(want)
    loose = total = moved = 0
    for k in sorted(want):
        w, p0 = want[k].numpy(), before[k].numpy()
        d = np.abs(got[k].numpy() - w)
        over = d > 1e-5
        if over.any():
            gj, gt = np.abs(mu_j[k].numpy()), np.abs(mu_t[k].numpy())
            rounding = (gj <= 1e-6 * gj.max()) & (gt <= 1e-6 * gt.max())
            assert rounding[over].all(), (k, d[over & ~rounding].max())
            bound = 2 * dp_run["lr0"] * (1 + 0.01 * np.abs(p0)) + 1e-5
            assert (d[over] <= bound[over]).all(), k
        loose += int(over.sum())
        total += d.size
        moved += not torch.equal(got[k], before[k])
    assert moved > 0.9 * len(want), moved
    assert loose <= 1e-4 * total, (loose, total)


@pytest.mark.parametrize("stage", ["first", "uninterrupted"])
def test_dp_ranks_hold_equal_parameters(dp_run, stage):
    """After each step both ranks hold the same parameters and optimizer
    state, bit for bit; each holds its own lane of the bank."""
    a, b = (r[stage] for r in dp_run["ranks"])
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for k, v in a["mu"].items():
        assert torch.equal(v, b["mu"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["nu"], b["nu"]))
    assert int(a["count"]) == int(b["count"]) == a["step"]
    assert a["memory"][0].shape[0] == 1
    assert not torch.equal(a["memory"][0], b["memory"][0])


def test_dp_save_and_resume_is_exact(dp_run):
    """Rank 0 wrote the state with both lanes of the bank in rank order;
    fresh ranks loaded it (each its lane), stepped, and hold exactly what
    the uninterrupted ranks hold."""
    ck = torch.load(dp_run["work"] / "iter_1.pth", weights_only=True)
    assert ck["step"] == 1 and ck["memory"][0].shape[0] == WORLD
    for r, rank in enumerate(dp_run["ranks"]):
        assert torch.equal(ck["memory"][0][r], rank["first"]["memory"][0][0])
        assert rank["loaded_bank_equal"], r
        assert rank["resume_exact"], r


def test_gather_results_multihost_round_trip(dp_run):
    """Every rank gets the union of the ranks' results, in rank order,
    values unchanged."""
    want = [(f"token-{r}-{i}", [{"score": 0.5 + 0.125 * i, "rank": r}])
            for r in range(WORLD) for i in range(3 + r)]
    for rank in dp_run["ranks"]:
        assert rank["gathered"] == want
    assert json.loads(json.dumps(dict(want))) == dict(want)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
