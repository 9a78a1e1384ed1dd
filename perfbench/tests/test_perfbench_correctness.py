"""The reference against the program at tiny sizes on the CPU, and the
comparison that decides ``correct`` against planted faults and the
control. Only these tests import both the reference and the program."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import check
from perfbench.cell import run_cell
from perfbench.faults import FAULTS
from perfbench.program import BANK_FIELDS
from perfbench.reference import model as ref
from perfbench.tests.conftest import (REPO, TINY_CELL, TINY_LIMITS,
                                      tiny_config_file)
from perfbench.traffic import Stream, load
from perfbench.weights import make_state_dict


def _stream_both(pad_shape, seed, frames=3, norm1_bias=True):
    """Stream the tiny configuration at ``pad_shape`` through the program's
    infer_step and the reference, each from its own bank, on the
    benchmark's weights (without norm1's biases when ``norm1_bias`` is
    False); yields each frame's numbers."""
    from toc3d_tpu_torch.configs import get_config
    from toc3d_tpu_torch.models.detector import (build_detector, infer_step,
                                                 init_state)
    pcfg = get_config("tiny", pad_shape=tuple(pad_shape))
    cfg_file = tiny_config_file(pad_shape=list(pad_shape))
    sd = make_state_dict(cfg_file, seed, "cpu")
    if not norm1_bias:
        for k, v in sd.items():
            if k.endswith(".norm1.bias"):
                v.zero_()
    model = build_detector(pcfg, device="cpu", state_dict=sd)
    stream = Stream(load("stream_b1", REPO), cfg_file, seed, pin=False)
    state = init_state(1, pcfg, device="cpu")
    bank = ref.empty_bank(cfg_file, 1, "cpu")
    topk = cfg_file["head"]["topk_proposals"]
    for i in range(frames):
        fr = stream.frame(i)
        state, det = infer_step(model, state, fr)
        out, bank = ref.frame_forward(sd, cfg_file, fr, bank)
        host = lambda d: {n: v.double().numpy() for n, v in d.items()}
        nums = check.frame_numbers(
            tuple(t.numpy() for t in (det.bboxes, det.scores, det.labels)),
            out["logits"].double().numpy(), out["boxes"].double().numpy())
        nums.update(check.bank_numbers(
            host(dict(zip(BANK_FIELDS, state.memory))), host(out),
            host(bank), topk))
        yield nums


def test_reference_agrees_with_the_program_at_tiny():
    """Three streamed frames (a scene start, then two that carry each
    side's own bank) at a map of whole windows."""
    for nums in _stream_both((64, 128), 2 ** 35 + 11):
        assert nums["logit_max"] < 1e-4 and nums["centre_max"] < 1e-4
        assert nums["score_gap"] < 1e-4 and nums["emb_p90"] < 1e-4
        assert nums["bank_old_max"] < 1e-4


def test_known_fault_out_of_image_rows_after_norm1():
    """The program normalises a full block's out-of-image window rows
    (LN(0) = norm1's bias) where the reference zero-pads after norm1: at a
    map that pads its windows the two part on the benchmark's weights, and
    agree once norm1 has no bias (PERF.md, Open questions)."""
    biased = next(_stream_both((80, 144), 5, frames=1))
    plain = next(_stream_both((80, 144), 5, frames=1, norm1_bias=False))
    assert plain["logit_max"] < 1e-4 and plain["emb_p90"] < 1e-4
    assert biased["logit_max"] > 100 * plain["logit_max"]
    assert biased["emb_p90"] > 100 * plain["emb_p90"]


def _tiny_run(tiny_checkout, **kw):
    root, bench = tiny_checkout
    res, checks = run_cell(bench, TINY_CELL, 2 ** 33 + 3, 1.5, False, "cpu",
                           root, **kw)
    return res, {n: v for n, v, _ in checks}


def test_a_sound_tiny_run_is_correct(tiny_checkout):
    res, nums = _tiny_run(tiny_checkout)
    assert res["correct"], nums
    assert set(nums) == set(TINY_LIMITS)
    assert res["attempted"] > 8 and res["failed"] == 0
    kinds = [j[1] for j in res["_judged"]]
    assert kinds == ["scene start"] + ["mid-scene"] * 6
    for _, kind, nums in res["_judged"]:
        assert nums["logit_max"] < 1e-4 and nums["centre_max"] < 1e-4
        assert nums["emb_p90"] < 1e-4 and nums["bank_centre_med"] < 1e-4
        assert nums["bank_old_max"] < 1e-4


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_are_not_correct(tiny_checkout, fault):
    res, nums = _tiny_run(tiny_checkout, wrap_entry=FAULTS[fault])
    assert not res["correct"], nums


def test_the_control_is_not_correct(tiny_checkout):
    """The control: the program's own int8 path (backbone and decoder)
    in its place."""
    res, nums = _tiny_run(tiny_checkout, control=True)
    assert not res["correct"], nums


def test_numbers_ignore_the_order_of_reference_queries():
    rng = np.random.default_rng(0)
    q, c, k = 40, 10, 16
    logits = rng.normal(-4, 1, (1, q, c))
    boxes = np.concatenate([rng.normal(0, 20, (1, q, 3)),
                            rng.uniform(0.5, 3, (1, q, 3)),
                            rng.uniform(-3, 3, (1, q, 1)),
                            rng.normal(0, 1, (1, q, 2))], -1)
    flat = logits.reshape(1, -1)
    idx = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    det = (boxes[0][idx[0] // c][None].astype(np.float32),
           (1 / (1 + np.exp(-np.take_along_axis(flat, idx, 1))))
           .astype(np.float32), idx % c)
    base = check.frame_numbers(det, logits, boxes)
    perm = rng.permutation(q)
    again = check.frame_numbers(det, logits[:, perm], boxes[:, perm])
    assert base == pytest.approx(again)
    assert base["centre_max"] < 1e-5 and base["logit_max"] < 1e-5
    moved = (det[0].copy(), det[1], det[2])
    moved[0][0, 3, 0] += 10.0
    assert check.frame_numbers(moved, logits, boxes)["centre_rms"] > 0.1
