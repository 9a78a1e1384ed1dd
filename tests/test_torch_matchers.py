"""The port's two training matchers against the JAX package's, on the CPU:

* the native LAP twin (toc3d_tpu_torch/native, lap.cpp built with g++)
  against scipy on tests/test_native_lap.py's seeds, and equal to JAX's
  ``toc3d_tpu.native.lap_batched`` element for element, padding included;
  a build that fails raises with the compiler's log, and nothing falls
  back to scipy;
* the plain auction (core/auction.auction_plain, the CPU path and the CUDA
  kernel's oracle) equal to JAX's ``hungarian_match_auction`` on the same
  numpy costs, element for element, at the cases of tests/test_auction.py
  and tests/test_auction_scale.py (G 8 / 32 / 96 of 96 at Q 900, planted
  near ties, padded batches);
* ``hungarian_match``'s two matchers on the real problems of a tiny train
  step (three seeds): no query twice, at least 0.999 of the slots alike,
  the auction's total cost within JAX's bound of the LAP's optimum
  (relative gap < 1e-4); the per-device default and ``set_default_impl``;
* the tracker's ``_hungarian`` equal to JAX's on rectangular and
  infeasible distance matrices.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

sys.path.insert(0, os.path.dirname(__file__))

from toc3d_tpu import native as jax_native
from toc3d_tpu.core.auction import hungarian_match_auction
from toc3d_tpu.tracking import metrics as jax_metrics

from test_auction_scale import realistic_cost
from test_torch_train_step import make_batch

from toc3d_tpu_torch import native
from toc3d_tpu_torch.core import assigner
from toc3d_tpu_torch.core.auction import auction_plain
from toc3d_tpu_torch.tracking import metrics

BIG = 1e6


# ---------------------------------------------------------------------------
# the native LAP
# ---------------------------------------------------------------------------

def _lap_cases():
    """tests/test_native_lap.py's problems: 30 random (r, c) with r <= c
    (RandomState(0)), a padded batch (RandomState(1))."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(30):
        r = rng.randint(1, 30)
        c = rng.randint(r, 200)
        cost = (rng.randn(r, c) * rng.uniform(0.1, 50)).astype(np.float32)
        out.append((cost[None], np.array([r])))
    rng = np.random.RandomState(1)
    out.append((rng.randn(3, 8, 40).astype(np.float32), np.array([8, 3, 0])))
    return out


@pytest.mark.parametrize("case", range(31))
def test_native_lap_equals_jax_and_scipy(case):
    cost, nv = _lap_cases()[case]
    out = native.lap_batched(cost, nv)
    ref = jax_native.lap_batched(cost, nv)
    assert out.dtype == np.int32 and out.shape == cost.shape[:2]
    np.testing.assert_array_equal(out, ref)
    for i, n in enumerate(nv):
        assert (out[i, n:] == -1).all()
        if n == 0:
            continue
        m = out[i, :n]
        assert (m >= 0).all() and len(set(m.tolist())) == n
        rows, cols = linear_sum_assignment(cost[i, :n])
        np.testing.assert_allclose(cost[i, np.arange(n), m].sum(),
                                   cost[i, rows, cols].sum(), rtol=1e-5,
                                   atol=1e-4)


def test_lsa_host_native_equals_scipy_oracle():
    """lsa_host (one native call for the batch, test_native_lap.py's
    seed 2) reaches scipy's optimum per sample, and equals JAX's
    _lsa_host."""
    from toc3d_tpu.core.assigner import _lsa_host
    rng = np.random.RandomState(2)
    cost = rng.randn(4, 50, 7).astype(np.float32) * 10
    nv = np.array([7, 7, 2, 0], np.int32)
    out = assigner.lsa_host(cost, nv)
    ref = assigner.lsa_host_scipy(cost, nv)
    np.testing.assert_array_equal(out, _lsa_host(cost, nv))
    for i, n in enumerate(nv):
        assert (out[i, n:] == -1).all() and (ref[i, n:] == -1).all()
        cols = np.arange(n)
        np.testing.assert_allclose(cost[i, out[i, :n], cols].sum(),
                                   cost[i, ref[i, :n], cols].sum(),
                                   rtol=1e-5, atol=1e-4)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with its log; lsa_host does
    not fall back to scipy."""
    bad = tmp_path / "lap.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for lap.cpp"):
        native.get_lap_lib()
    with pytest.raises(RuntimeError):
        assigner.lsa_host(np.zeros((1, 4, 2), np.float32),
                          np.array([2], np.int32))
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        native.get_lap_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_solver_error_raises():
    """More valid rows than columns is an error of the solver: raised,
    not returned as None."""
    with pytest.raises(RuntimeError, match="solve_lap_batched"):
        native.lap_batched(np.zeros((1, 5, 3), np.float32),
                           np.array([5], np.int32))


# ---------------------------------------------------------------------------
# the auction
# ---------------------------------------------------------------------------

def _auction_random():
    """tests/test_auction.py: 20 random problems (RandomState(0)) as
    (1, O, P) costs, and the padded batch (RandomState(1))."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(20):
        p, o = rng.randint(2, 24), rng.randint(32, 128)
        cost = rng.randn(p, o).astype(np.float32) * rng.uniform(0.5, 20)
        out.append((np.ascontiguousarray(cost.T)[None], np.array([p])))
    rng = np.random.RandomState(1)
    out.append((rng.randn(3, 40, 8).astype(np.float32) * 5,
                np.array([8, 3, 0])))
    return out


def _auction_equal(cost, nv):
    ref = np.asarray(hungarian_match_auction(jnp.asarray(cost),
                                             jnp.asarray(nv)))
    out = auction_plain(torch.from_numpy(cost), torch.from_numpy(nv))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    return out.numpy()


@pytest.mark.parametrize("case", range(21))
def test_auction_plain_equals_jax_random(case):
    cost, nv = _auction_random()[case]
    out = _auction_equal(cost, nv)
    for i, n in enumerate(nv):
        assert (out[i, n:] == -1).all()
        assert len(set(out[i, :n].tolist())) == n and (out[i, :n] >= 0).all()


@pytest.mark.parametrize("g", [8, 32, 96])
def test_auction_plain_equals_jax_at_scale(g):
    """tests/test_auction_scale.py's realistic costs, Q 900 padded to 96
    slots; also JAX's bounds against the exact LAP."""
    rng = np.random.RandomState(g)
    costs = np.full((4, 900, 96), BIG, np.float32)
    for i in range(4):
        costs[i, :, :g] = realistic_cost(rng, 900, g)
    nv = np.full((4,), g, np.int32)
    out = _auction_equal(costs, nv)
    exact = assigner.lsa_host(costs, nv)
    agree = 0
    for i in range(4):
        cols = np.arange(g)
        assert len(set(out[i, :g].tolist())) == g
        c_a = costs[i, out[i, :g], cols].astype(np.float64).sum()
        c_l = costs[i, exact[i, :g], cols].astype(np.float64).sum()
        assert (c_a - c_l) / max(abs(c_l), 1e-6) < 1e-4
        agree += int((out[i, :g] == exact[i, :g]).sum())
    assert agree / (4 * g) >= 0.999


def test_auction_plain_equals_jax_near_ties():
    """tests/test_auction_scale.py:79-100: GT pairs planted on one query."""
    rng = np.random.RandomState(0)
    q, g = 900, 32
    cost = rng.rand(q, g).astype(np.float32) * 10
    for j in range(0, g, 2):
        i = rng.randint(0, q)
        cost[i, j] = 0.0
        cost[i, j + 1] = 1e-3
        cost[(i + 1) % q, j + 1] = 2e-3
    nv = np.array([g], np.int32)
    out = _auction_equal(cost[None], nv)[0]
    exact = assigner.lsa_host(cost[None], nv)[0]
    assert len(set(out.tolist())) == g
    cols = np.arange(g)
    c_a, c_l = cost[out, cols].sum(), cost[exact, cols].sum()
    assert c_a - c_l < 1e-3 + 1e-4 * abs(c_l)


def test_auction_plain_max_iters_and_stats():
    """A person still unassigned when the rounds run out keeps -1, as in
    JAX; stats count the rounds and bids."""
    cost = np.array([[[0.0, 1.0], [0.0, 1.0], [5.0, 5.0]]], np.float32)
    nv = np.array([2], np.int32)
    st = {}
    full = auction_plain(torch.from_numpy(cost), torch.from_numpy(nv),
                         stats=st)
    assert sorted(full[0].tolist()) == [0, 1] and st["rounds"] >= 2
    assert st["bids"] >= 3
    one = auction_plain(torch.from_numpy(cost), torch.from_numpy(nv),
                        max_iters=1)
    assert one[0].tolist() == [0, -1]


def _tiny_step_problems(seed):
    """The cost tensors of one tiny train step on the CPU (the two decoder
    layers' (2, 32, 4) and the 2D head's (4, 32, 4)), captured at
    hungarian_match."""
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import build_detector
    from toc3d_tpu_torch.runtime import train as tr
    cfg = get_config("tiny")
    model = build_detector(cfg, device="cpu", seed=seed)
    batch, steady = tr.batch_to_device(
        make_batch(np.random.RandomState(seed), 2, 2, 64, 128), "cpu")
    noise = tr.draw_train_noise(cfg, 2, 2, torch.Generator().manual_seed(
        seed), "cpu")
    captured = []
    match = tr.hungarian_match

    def keep(problems, impl=None):
        captured.extend((c.detach().clone(), v.clone()) for c, v in problems)
        return match(problems, impl)
    tr.hungarian_match = keep
    try:
        with torch.no_grad():
            tr.compute_losses(model, tr.init_train_state(
                model, tr.make_optimizer(model), 2).memory, batch, noise,
                steady=steady)
    finally:
        tr.hungarian_match = match
    return captured


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matchers_agree_on_tiny_step(seed):
    problems = _tiny_step_problems(seed)
    assert [tuple(c.shape) for c, _ in problems] == [(2, 32, 4), (2, 32, 4),
                                                     (4, 32, 4)]
    auct = assigner.hungarian_match(problems, impl="auction")
    lap = assigner.hungarian_match(problems, impl="callback")
    agree = total = 0
    for (c, v), a, l in zip(problems, auct, lap):
        assert a.dtype == l.dtype == torch.int64
        assert torch.equal(a < 0, ~v) and torch.equal(l < 0, ~v)
        cols = torch.arange(c.shape[2])
        for i in range(c.shape[0]):
            keep = v[i]
            assert len(set(a[i][keep].tolist())) == int(keep.sum())
            ca = c[i, a[i][keep], cols[keep]].double().sum().item()
            cl = c[i, l[i][keep], cols[keep]].double().sum().item()
            assert (ca - cl) / max(abs(cl), 1e-6) < 1e-4
        agree += int(((a == l) & v).sum())
        total += int(v.sum())
    assert agree / total >= 0.999


def test_default_impl_per_device():
    """'callback' on the CPU, 'auction' on a CUDA device (JAX: callback on
    the CPU backend, auction on an accelerator); set_default_impl pins one
    for every call."""
    assert assigner.resolve_impl("cpu") == "callback"
    assert assigner.resolve_impl(torch.device("cuda", 0)) == "auction"
    cost = torch.from_numpy(np.random.RandomState(4).randn(2, 12, 3)
                            .astype(np.float32))
    valid = torch.tensor([[True, True, False], [True, True, True]])
    try:
        assigner.set_default_impl("auction")
        assert assigner.resolve_impl("cpu") == "auction"
        a = assigner.hungarian_match([(cost, valid)])[0]
        assigner.set_default_impl("callback")
        assert assigner.resolve_impl("cuda") == "callback"
        c = assigner.hungarian_match([(cost, valid)])[0]
        with pytest.raises(ValueError):
            assigner.set_default_impl("scipy")
        with pytest.raises(ValueError):
            assigner.hungarian_match([(cost, valid)], impl="scipy")
    finally:
        assigner.set_default_impl(None)
    assert assigner.resolve_impl("cpu") == "callback"
    assert torch.equal(a, c) and (a[0, 2] == -1)


# ---------------------------------------------------------------------------
# the tracker's assignment
# ---------------------------------------------------------------------------

def _dists():
    rng = np.random.RandomState(5)
    wide = rng.rand(3, 7) * 3
    tall = rng.rand(8, 4) * 3
    inf = rng.rand(5, 6) * 3
    inf[inf > 2.0] = np.nan                  # the devkit's infeasible pairs
    inf[1] = np.nan                          # a row with no feasible pair
    inf = np.where(np.isnan(inf), np.inf, inf)
    tall_inf = np.where(tall > 1.5, np.inf, tall)
    return [wide, tall, inf, tall_inf, np.zeros((0, 3)), np.full((2, 2),
                                                                  np.inf)]


@pytest.mark.parametrize("case", range(6))
def test_tracking_hungarian_equals_jax(case):
    dist = _dists()[case]
    assert metrics._hungarian(dist) == jax_metrics._hungarian(dist)
