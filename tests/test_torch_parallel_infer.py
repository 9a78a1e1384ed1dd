"""View-sharded streaming inference of the port (parallel/infer_spmd.py)
against the JAX package's ``make_spmd_infer_fn`` and against the port's own
single-process ``make_infer_fn``, on the CPU in f32 at the ``tiny`` preset.

The JAX side runs in this process on its virtual CPU devices; the port's
side is one launch of four spawned ranks over gloo (rendezvous through a
FileStore in the test's directory, one thread each), which build three
meshes in turn: views (2 views over 2 ranks), (6 views over 3 ranks) and
a ('data', 'view') product mesh of 2 x 2 at batch 2, from the same
reference-named state dict. Each case streams 3 frames (prev_exists 0, 1,
1) through JAX's make_spmd_infer_fn and the port's single-process
make_infer_fn; the ranks run each of those frames from each reference's
bank before it, so a near tie resolved the other way in one frame's bank
does not carry into the next frame's comparison.

Comparison (tests/test_torch_presets.py's _compare, lane by lane, and the
top-k boundary: _near_tie_compare): scores by rank; boxes, labels and
validity at each rank but among near-tied scores, which random weights
give and a last-bit difference orders either way; the carried bank slots
slot by slot, the frame's new ones each equal to one of the reference's
but for the top-k boundary's. Tolerances: 1e-3
against JAX's make_spmd_infer_fn, 1e-5 against the port's single-process
make_infer_fn (each rank's products have other row counts, so last bits
differ); the ranks of a view group equal bit for bit (the head is
replicated). Also: the
mesh-shape rules of tests/test_infer_spmd.py against JAX's view_mesh and
product_mesh, the meshes the four ranks built, the gumbel mask refused,
and the captured programs of ShardedCapturedInfer with CPU stand-ins for
the CUDA graph API (one spawned rank).

Run as a script, this file is one rank (``_rank_main``; with a fourth
argument ``captured``, ``_captured_rank``): it imports neither JAX nor the
JAX package.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from toc3d_tpu_torch.configs import get_config  # noqa: E402
from toc3d_tpu_torch.parallel import infer_spmd as ts  # noqa: E402

WORLD = 4
BANK = ("embedding", "reference_point", "timestamp", "egopose", "velo")
# (name, views, lanes, mesh: ('view', n_devices) or ('product', n_data))
CASES = (("views2_over2", 2, 1, ("view", 2)),
         ("views6_over3", 6, 1, ("view", 3)),
         ("product2x2", 2, 2, ("product", 2)))


def _tcfg():
    cfg = get_config("tiny")
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, mxu_align_k=True))


def _outputs(state, det):
    return {"det": {k: v.clone() for k, v in det._asdict().items()},
            "memory": {n: getattr(state.memory, n).clone() for n in BANK}}


def _rank_main(rank: int, world: int, work: str) -> None:
    """One rank: every case's mesh (built on all ranks) and, when this rank
    is in the mesh, each frame of the case run from each reference's bank
    before it (JAX's and the single process's). Writes rank{rank}.pt into
    ``work``."""
    import torch.distributed as dist
    from toc3d_tpu_torch.core.state import DetectorState
    from toc3d_tpu_torch.models.detector import build_detector
    from toc3d_tpu_torch.models.streampetr_head import MemoryBank
    from toc3d_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_distributed(f"file://{work}/store", world, rank, "cpu")
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    model = build_detector(_tcfg(), device="cpu",
                           state_dict=inputs["state_dict"])
    out = {}
    for name, views, lanes, (kind, size) in CASES:
        pm = ts.view_mesh(views, n_devices=size) if kind == "view" else \
            ts.product_mesh(views, n_data=size)
        rec = {"shape": pm.shape, "member": pm.member,
               "index": (pm.data_index, pm.view_index)}
        if pm.member:
            infer = ts.make_spmd_infer_fn(model, pm)
            rec["frames"] = {}
            own = slice(pm.data_index * lanes // pm.data,
                        (pm.data_index + 1) * lanes // pm.data)
            for ref, banks in inputs["banks"][name].items():
                rec["frames"][ref] = []
                for frame, bank in zip(inputs["frames"][name], banks):
                    state = DetectorState(MemoryBank(*(
                        torch.as_tensor(np.asarray(bank[n])[own])
                        for n in BANK)))
                    state, det = infer(state, frame)
                    rec["frames"][ref].append(_outputs(state, det))
        out[name] = rec
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _captured_rank(rank: int, world: int, work: str) -> None:
    """test_sharded_captured_programs_are_kept_until_layout_change's rank:
    ShardedCapturedInfer on a CPU model with the CPU stand-ins for the
    CUDA graph API (a capture runs its function, a replay does nothing)."""
    import torch.distributed as dist
    from cuda_standins import install
    from toc3d_tpu_torch.models import detector as td
    from toc3d_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    install(setattr)
    mesh.init_distributed(f"file://{work}/store", world, rank, "cpu")
    cfg = get_config("tiny")
    model = td.build_detector(cfg, device="cpu", seed=1)
    infer = ts.ShardedCapturedInfer(model, ts.view_mesh(2))
    runner = infer.runner
    g = torch.Generator().manual_seed(4)

    def frame(t, pe, b=1):
        f = td.synthetic_frame(g, t, batch=b, views=2, height=64, width=128,
                               device="cpu")
        f["prev_exists"] = torch.full((b,), pe)
        return f

    state, seen = td.init_state(1, cfg, device="cpu"), {}
    for t, pe in enumerate((0.0, 1.0, 1.0, 0.0, 1.0)):
        f = frame(t, pe)
        out = infer(state, f)
        if t == 0:
            want = td.infer_step(model, state, f)
            for a, b in zip(_outputs(*out).values(),
                            _outputs(*want).values()):
                for k in a:
                    assert torch.equal(a[k], b[k]), k
            buffers, gather = dict(runner.frame), infer._gather
        state = out[0]
        for name, prog in runner.programs.items():
            assert seen.setdefault(name, prog) is prog, (t, name)
        assert all(runner.frame[k] is v for k, v in buffers.items())
        assert infer._gather is gather and gather[0] is runner.feats
    assert set(map(str, seen)) == {str(("backbone+neck", False)),
                                   str(("backbone+neck", True)),
                                   "head+decode"}
    infer(td.init_state(2, cfg, device="cpu"), frame(5, 1.0, b=2))
    assert list(map(str, runner.programs)) == [
        str(("backbone+neck", True)), "head+decode"]
    assert all(p is not seen[k] for k, p in runner.programs.items())
    assert runner.frame["img"] is not buffers["img"]
    assert infer._gather is not gather and infer._gather[0] is runner.feats
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """JAX's view-sharded streams, the port's single-process ones, then
    the four ranks'."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from toc3d_tpu.configs import get_config as jax_get_config
    from toc3d_tpu.models.detector import init_state as jax_init_state
    from toc3d_tpu.parallel.infer_spmd import make_spmd_infer_fn
    from toc3d_tpu.runtime.checkpoint import convert_detector_checkpoint
    from toc3d_tpu_torch.models import detector as td
    from test_full_converter import build_reference_state_dict
    from test_parity_detector import make_frames
    from test_torch_parallel_train import launch_ranks

    work = tmp_path_factory.mktemp("spmd")
    jcfg = jax_get_config("tiny")
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, mxu_align_k=True))
    rng = np.random.RandomState(5)
    sd = build_reference_state_dict(jcfg, rng)
    params = convert_detector_checkpoint(sd, jcfg)
    model = td.build_detector(_tcfg(), device="cpu", state_dict=sd)
    frames, jax_out, single, banks = {}, {}, {}, {}
    for name, views, lanes, (kind, size) in CASES:
        frames[name] = make_frames(rng, jcfg, t_total=3, b=lanes, n=views)
        devs = np.asarray(jax.devices()[:size * (2 if kind == "product"
                                                 else 1)])
        jmesh = Mesh(devs.reshape(2, 2), ("data", "view")) \
            if kind == "product" else Mesh(devs, ("view",))
        jinfer = make_spmd_infer_fn(jcfg, jmesh)
        tinfer = td.make_infer_fn(model)
        jstate = jax_init_state(lanes, jcfg)
        tstate = td.init_state(lanes, model.cfg, device="cpu")
        jax_out[name], single[name] = [], []
        banks[name] = {"jax": [], "single": []}
        for f in frames[name]:
            banks[name]["jax"].append({n: np.asarray(getattr(
                jstate.memory, n)) for n in BANK})
            banks[name]["single"].append({n: getattr(tstate.memory, n)
                                          for n in BANK})
            jstate, jdet = jinfer(params, jstate,
                                  {k: jnp.asarray(v) for k, v in f.items()})
            jax_out[name].append(
                {"det": {k: np.asarray(v) for k, v in
                         jdet._asdict().items()},
                 "memory": {n: np.asarray(getattr(jstate.memory, n))
                            for n in BANK}})
            tstate, tdet = tinfer(tstate, f)
            single[name].append(_outputs(tstate, tdet))
    torch.save({"state_dict": sd, "frames": frames, "banks": banks},
               work / "inputs.pt")
    launch_ranks(__file__, WORLD, str(work))
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(jax=jax_out, single=single, ranks=ranks)


def _joined(ranks, name, ref):
    """A case's frames run from reference ``ref``'s banks, the lanes of its
    data groups joined in order (each view group's first rank holds them),
    after checking that every rank of a view group holds the same outputs
    bit for bit."""
    members = [r[name] for r in ranks if r[name]["member"]]
    shape = members[0]["shape"]
    groups = {}
    for r in members:
        groups.setdefault(r["index"][0], []).append(r["frames"][ref])
    assert sorted(groups) == list(range(shape["data"]))
    for di, reps in groups.items():
        assert len(reps) == shape["view"]
        for rep in reps[1:]:
            for fa, fb in zip(reps[0], rep):
                for part in ("det", "memory"):
                    for k, v in fa[part].items():
                        assert torch.equal(v, fb[part][k]), (name, di, k)
    return [{part: {k: torch.cat([groups[di][0][t][part][k]
                                  for di in sorted(groups)])
                    for k in groups[0][0][t][part]}
             for part in ("det", "memory")}
            for t in range(len(groups[0][0]))]


def _near_tie_compare(msg, g, ref, lane, tol, topk):
    """tests/test_torch_presets.py's _compare on one lane, at ``tol``, with
    the top-k boundary: scores by rank; each box, label and validity at
    its rank, except that ranks whose reference scores lie within 1e-6 of
    the port's are near ties (random weights score every query alike, and
    a last-bit difference in a product of other row counts orders such
    ranks either way), so the port's box must equal one of theirs; a box
    that equals none of them is a near tie at the boundary of the decode's
    top-k when its score lies within 1e-6 of the reference's last kept
    score, as many times as the reference has such scores. The bank: the
    slots carried from the bank before the frame (both sides start from
    the reference's) equal slot by slot; each of the ``topk`` slots the
    frame's top queries filled equals one of the reference's new slots,
    but for at most one, the near tie at the top-k boundary."""
    num = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    gd, rd = g["det"], ref["det"]
    ts_, rs = num(gd["scores"][lane]), num(rd["scores"][lane])
    np.testing.assert_allclose(ts_, rs, atol=tol, err_msg=f"{msg} scores")
    tb, rb = num(gd["bboxes"][lane]), num(rd["bboxes"][lane])
    tl, rl = num(gd["labels"][lane]), num(rd["labels"][lane])
    tv, rv = num(gd["valid"][lane]), num(rd["valid"][lane])
    boundary = int((np.abs(rs - rs[-1]) <= 1e-6).sum())
    for i in range(len(ts_)):
        tied = np.flatnonzero(np.abs(rs - ts_[i]) <= 1e-6)
        if any(np.allclose(tb[i], rb[k], atol=tol, rtol=tol)
               and tl[i] == rl[k] and tv[i] == rv[k]
               for k in sorted(tied, key=lambda k: abs(k - i))):
            continue
        boundary -= 1
        assert abs(ts_[i] - rs[-1]) <= 1e-6 and boundary >= 0, \
            f"{msg} box {i}: {tb[i]} against {rb[i]}"
    slots = len(num(g["memory"]["embedding"][lane]))
    tm = [num(g["memory"][n][lane]).reshape(slots, -1) for n in BANK]
    rm = [num(ref["memory"][n][lane]).reshape(slots, -1) for n in BANK]
    same = lambda a, b: all(np.allclose(x[a], y[b], atol=tol, rtol=0)
                            for x, y in zip(tm, rm))
    for i in range(topk, slots):
        assert same(i, i), f"{msg} carried memory slot {i}"
    free, unmatched = set(range(topk)), 0
    for i in range(topk):
        k = next((k for k in sorted(free, key=lambda k: abs(k - i))
                  if same(i, k)), None)
        if k is None:
            unmatched += 1
        else:
            free.discard(k)
    assert unmatched <= 1, f"{msg}: {unmatched} new memory slots unmatched"


def _compare_case(streams, case, ref, tol):
    got = _joined(streams["ranks"], case, ref)
    want = streams[ref][case]
    topk = get_config("tiny").head.topk_proposals
    for t, (g, r) in enumerate(zip(got, want)):
        for lane in range(len(r["det"]["scores"])):
            _near_tie_compare(f"{case} frame {t} lane {lane}", g, r, lane,
                              tol, topk)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_spmd_matches_jax_spmd(streams, case):
    """Each lane of each frame, run from JAX's bank before it, against
    JAX's view-sharded stream at 1e-3 (_near_tie_compare)."""
    _compare_case(streams, case, "jax", 1e-3)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_spmd_matches_single_process(streams, case):
    """Each lane of each frame, run from the single process's bank before
    it, against the port's single-process make_infer_fn on the same frames
    at 1e-5 (_near_tie_compare)."""
    _compare_case(streams, case, "single", 1e-5)


def test_process_meshes_of_four_ranks(streams):
    """The meshes the four ranks built: members, shapes and indices."""
    want = {"views2_over2": ({"data": 1, "view": 2}, 2),
            "views6_over3": ({"data": 1, "view": 3}, 3),
            "product2x2": ({"data": 2, "view": 2}, 4)}
    for name, (shape, members) in want.items():
        for r, rank in enumerate(streams["ranks"]):
            rec = rank[name]
            assert rec["shape"] == shape, (name, r)
            assert rec["member"] == (r < members), (name, r)
            if rec["member"]:
                assert rec["index"] == divmod(r, shape["view"]), (name, r)


@pytest.mark.parametrize("views,limit,want", [
    (6, 8, 6), (2, 8, 2), (6, 4, 3), (6, 1, 1)])
def test_view_mesh_divisor(views, limit, want):
    """test_infer_spmd.test_view_mesh_divisor's cases, against JAX's
    view_mesh on its 8 virtual devices."""
    from toc3d_tpu.parallel.infer_spmd import view_mesh
    assert ts.mesh_shape(views, limit, 1) == (1, want)
    assert view_mesh(views, n_devices=limit).devices.size == want


@pytest.mark.parametrize("views,n_data,want", [
    (6, None, (1, 6)), (6, 2, (2, 3)), (6, 4, (4, 2)), (2, 2, (2, 2))])
def test_product_mesh_shapes(views, n_data, want):
    """test_infer_spmd.test_product_mesh_shapes's cases, against JAX's
    product_mesh on its 8 virtual devices."""
    from toc3d_tpu.parallel.infer_spmd import product_mesh
    assert ts.mesh_shape(views, 8, n_data) == want
    jm = product_mesh(views, n_data=n_data)
    assert (jm.shape["data"], jm.shape["view"]) == want
    with pytest.raises(ValueError, match="do not fit"):
        ts.mesh_shape(views, 8, 9)


def test_sharded_captured_programs_are_kept_until_layout_change(tmp_path):
    """The view-sharded frame on a CUDA model (ShardedCapturedInfer) with
    CPU stand-ins for the CUDA graph API (tests/cuda_standins.py), at the
    tiny preset, one rank over gloo in a process of its own: over a stream
    with a scene reset each program (backbone + neck per steady value,
    head + decode) is captured once, at its first use, and kept, as are the
    frame's buffers and the all-gather's; the first frame's result (its
    programs' eager first runs and the gather between them) is eager
    infer_step's bit for bit. A frame of another batch drops the programs
    and the buffers and captures anew."""
    from test_torch_parallel_train import launch_ranks
    launch_ranks(__file__, 1, str(tmp_path), "captured")


def test_gumbel_rejected():
    from toc3d_tpu_torch.models.detector import build_detector
    cfg = get_config("tiny")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, eval_mask="gumbel"))
    model = build_detector(cfg, device="cpu", seed=0)
    pm = ts.ProcessMesh(1, 2, True, 0, 0, None, None)
    with pytest.raises(ValueError, match="single-process"):
        ts.make_spmd_infer_fn(model, pm)


if __name__ == "__main__":
    main = _captured_rank if sys.argv[4:] == ["captured"] else _rank_main
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
