"""The training matchers and the closed loop on the card: the auction kernel
(ops/cuda/auction.auction_match, csrc/auction.cu) against its plain
version (core/auction.auction_plain) at edge shapes the ToC3D_faster step
of chip_smoke.py does not reach (one GT slot, as many slots as queries,
problems with no valid slot, Q 1000 with G 96, a batch of mixed valid
counts), equal element for element (``torch.equal``); hungarian_match's
default on a CUDA tensor (the auction, one launch a cost tensor); and a
30-iteration closed loop (toc3d_tpu_torch.tools.traineval) on the card.

The full proof (the 20k-iteration recipe of tests/test_traineval_closedloop.py,
mAP_present > 0.3) is opt-in: TOC3D_CLOSEDLOOP_FULL=1.

Every test needs a CUDA card and skips without one. This file imports no
JAX (run it with ``--noconftest`` on a host without JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_traineval_cuda.py -q
"""
import math
import os

import numpy as np
import pytest
import torch

from toc3d_tpu_torch.core.auction import auction_plain
from toc3d_tpu_torch.ops.cuda.auction import auction_match


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _costs(seed, b, q, g):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, q, g) * rng.uniform(0.5, 20)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,q,g,nv", [
    (3, 40, 1, (1, 1, 0)),          # one GT slot
    (2, 24, 24, (24, 24)),          # as many slots as queries
    (4, 64, 8, (0, 0, 0, 0)),       # no valid slot at all
    (2, 1000, 96, (96, 95)),        # Q 1000 with G 96
    (5, 300, 32, (32, 7, 0, 1, 31)),
])
def test_auction_kernel_equals_plain(dev, b, q, g, nv):
    cost = _costs(q + g, b, q, g)
    n_valid = torch.tensor(nv, dtype=torch.int32)
    before = auction_match.launches
    out = auction_match(torch.from_numpy(cost).to(dev), n_valid.to(dev))
    torch.cuda.synchronize()
    assert auction_match.launches == before + 1
    ref = auction_plain(torch.from_numpy(cost), n_valid)
    assert out.dtype == torch.int32 and out.shape == (b, g)
    assert torch.equal(out.cpu(), ref)
    for i, n in enumerate(nv):
        m = out[i].cpu().numpy()
        assert (m[n:] == -1).all() and (m[:n] >= 0).all()
        assert len(set(m[:n].tolist())) == n


@pytest.mark.cuda
def test_auction_kernel_near_ties(dev):
    """Planted near ties (tests/test_auction_scale.py:79-100): equal to
    the plain rounds."""
    rng = np.random.RandomState(3)
    q, g = 900, 32
    cost = rng.rand(q, g).astype(np.float32) * 10
    for j in range(0, g, 2):
        i = rng.randint(0, q)
        cost[i, j], cost[i, j + 1] = 0.0, 1e-3
        cost[(i + 1) % q, j + 1] = 2e-3
    nv = torch.tensor([g], dtype=torch.int32)
    out = auction_match(torch.from_numpy(cost[None]).to(dev), nv.to(dev))
    assert torch.equal(out.cpu(), auction_plain(torch.from_numpy(cost[None]),
                                                nv))


@pytest.mark.cuda
def test_default_matcher_on_card_is_the_auction(dev):
    """hungarian_match on CUDA tensors launches the kernel once a cost
    tensor and reads nothing back; the 'callback' matcher on the same
    problems reaches the same total cost."""
    from toc3d_tpu_torch.core.assigner import hungarian_match, resolve_impl
    assert resolve_impl(dev) == "auction"
    problems = []
    for seed, (b, q, g) in enumerate([(2, 90, 6), (4, 50, 4)]):
        c = torch.from_numpy(_costs(seed, b, q, g)).to(dev)
        v = torch.ones(b, g, dtype=torch.bool, device=dev)
        v[0, g - 1] = False
        c[0, :, g - 1] = 1e6
        problems.append((c, v))
    before = auction_match.launches
    auct = hungarian_match(problems)
    assert auction_match.launches == before + len(problems)
    lap = hungarian_match(problems, impl="callback")
    for (c, v), a, l in zip(problems, auct, lap):
        assert a.dtype == torch.int64 and a.device.type == "cuda"
        assert torch.equal(a < 0, ~v) and torch.equal(l < 0, ~v)
        cols = torch.arange(c.shape[2], device=dev)
        for i in range(c.shape[0]):
            keep = v[i]
            ca = c[i, a[i][keep], cols[keep]].double().sum().item()
            cl = c[i, l[i][keep], cols[keep]].double().sum().item()
            assert ca - cl < 1e-4 * abs(cl) + 1e-6


def _closed_loop(tmp_path, iters, extra=()):
    from toc3d_tpu_torch.tools import traineval
    out = traineval.main(["--config", "tiny", "--iters", str(iters),
                          "--data-dir", str(tmp_path / "data"),
                          "--out", str(tmp_path / "traineval.json"),
                          *extra])
    return out["record"]


@pytest.mark.cuda
def test_closed_loop_on_card(dev, tmp_path):
    """30 iterations in bf16 on the card: resumed at 15, evaluated at 0
    and 30 through the captured frame, finite metrics in [0, 1], the loss
    falling, the auction as matcher."""
    rec = _closed_loop(tmp_path, 30, ["--eval-points", "1",
                                      "--scenes", "2",
                                      "--frames-per-scene", "4",
                                      "--src-h", "90", "--src-w", "160"])
    assert rec["resumed"] is True and rec["matcher"] == "auction"
    assert rec["device"] == torch.cuda.get_device_name(dev)
    traj = rec["map_trajectory"]
    assert [p["iter"] for p in traj] == [0, 30]
    for p in traj:
        for k in ("mAP", "NDS", "mAP_present", "NDS_present"):
            assert math.isfinite(p[k]) and 0.0 <= p[k] <= 1.0
    assert rec["loss_last5_mean"] < rec["loss_first5_mean"]


@pytest.mark.cuda
def test_closed_loop_full_recipe(dev, tmp_path):
    """The overfit proof where the curve is flat (20k iterations of the
    recipe of tests/test_traineval_closedloop.py:72-82)."""
    if not os.environ.get("TOC3D_CLOSEDLOOP_FULL"):
        pytest.skip("a 20k-iteration training run; set "
                    "TOC3D_CLOSEDLOOP_FULL=1")
    rec = _closed_loop(tmp_path, 20000,
                       ["--lr", "1.5e-3", "--warmup", "50", "--batch-size",
                        "8", "--scenes", "8", "--objects", "3",
                        "--frames-per-scene", "8", "--eval-points", "2"])
    assert rec["resumed"] is True
    final = rec["map_trajectory"][-1]
    assert final["mAP_present"] > 0.3, final
    assert final["mAP"] > 0.1, final
    assert rec["loss_last5_mean"] < rec["loss_first5_mean"]
