"""The comparison that decides ``correct``: the boxes, scores and labels
that the timed path produced for a sample of the window's frames, against
the plain float32 reference (perfbench/reference) run on the same weights
and frames.

Frames compared, drawn from the seed (reservoir sampling over the window,
judged once it has closed):
* a scene start (prev_exists 0): the reference starts from an empty bank,
  so nothing of the program's state enters it;
* mid-scene frames: the reference starts from the bank the program carried
  into the frame and does the frame's whole bank update itself (the ego
  alignment going in, the new rows and the shift coming out). A replay of
  a scene from its start is no check: the two banks part at the first near
  tie of the bank's top-k, and in a compressing backbone the bank steers
  the token selectors, so the parting grows frame by frame;
* after each compared frame, the bank the program carried out of it
  against the reference's work on that frame (bank_numbers).

Numbers (frame_numbers, bank_numbers), each the largest over the compared
frames; a cell compares those its limits file names (perfbench/cells):
* ``score_gap``: the decoded scores of a frame, best first, against the
  reference's best max_decode sigmoid scores over queries x classes, as
  logits: the largest |logit(program) - logit(reference)| rank by rank;
* each decoded detection (box, score, label) is matched to the nearest
  reference query by the largest of its parts: centre distance (m), |log
  size| difference, wrapped yaw difference (rad), velocity difference
  (m/s) and the logit difference of its label ("match"); of each part the
  median (``<part>_med``), root mean square (``_rms``) and largest
  (``_max``) over the frame's detections. Matching makes near ties that
  two implementations order differently cost only the gap of the values;
  a box or score that no reference query produced reads far off;
* ``emb_med``, ``emb_p90``, ``bank_centre_med``, ``bank_old_max``: the
  bank that the program carried out of the frame (bank_numbers).
"""
from __future__ import annotations

import math

import numpy as np


def _logit(p):
    p = np.clip(p.astype(np.float64), 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


PARTS = ("centre", "size", "yaw", "velo", "logit", "match")


def frame_numbers(det, logits, boxes):
    """det: the program's (bboxes (B, K, 9), scores (B, K), labels (B, K))
    as numpy; logits (B, Q, C) and boxes (B, Q, 9) the reference's, numpy
    float64. Returns every number of this frame (see the module note)."""
    bboxes, scores, labels = det
    b, k = scores.shape
    ref_top = -np.sort(-logits.reshape(b, -1), axis=1)[:, :k]
    out = {"score_gap": float(np.abs(_logit(scores) - ref_top).max())}
    parts = {p: [] for p in PARTS}
    for lane in range(b):
        pb, rb = bboxes[lane].astype(np.float64), boxes[lane]
        comp = {
            "centre": np.abs(pb[:, None, :3] - rb[None, :, :3]).max(-1),
            "size": np.abs(np.log(np.maximum(pb[:, None, 3:6], 1e-12))
                           - np.log(rb[None, :, 3:6])).max(-1),
            "yaw": np.abs((pb[:, None, 6] - rb[None, :, 6] + math.pi)
                          % (2 * math.pi) - math.pi),
            "velo": np.abs(pb[:, None, 7:9] - rb[None, :, 7:9]).max(-1),
            "logit": np.abs(_logit(scores[lane])[:, None]
                            - logits[lane][:, labels[lane]].T)}
        comp["match"] = np.maximum.reduce(list(comp.values()))
        q = comp["match"].argmin(axis=1)
        for name, v in comp.items():
            parts[name].append(v[np.arange(k), q])
    for name in PARTS:
        v = np.concatenate(parts[name])
        out[f"{name}_med"] = float(np.median(v))
        out[f"{name}_rms"] = float(np.sqrt(np.mean(v * v)))
        out[f"{name}_max"] = float(v.max())
    return out


def bank_numbers(bank, ref_out, ref_bank, topk: int):
    """The program's bank after a frame against the reference's work on the
    same frame from the same bank. Its first ``topk`` rows take in the
    queries it propagated: each row's decoder output against the nearest
    of all the reference's queries' decoder outputs, as the RMS of the
    difference over the reference query's RMS (``emb_med``, ``emb_p90``:
    the median and 90th percentile over the rows), and the row's centre
    against the nearest of the reference queries' centres
    (``bank_centre_med``: the median over the rows, m, in the global frame
    that the bank keeps). A query that two implementations swap at the
    bank's top-k boundary costs only its own row. The rows after them, the bank
    the frame carried, against the reference's row by row
    (``bank_old_max``: the largest absolute difference of any field).
    numpy in, float64."""
    emb, pts = bank["embedding"], bank["reference_point"]
    rel, centre = [], []
    for lane in range(emb.shape[0]):
        q = ref_out["queries"][lane]
        e = emb[lane, :topk]
        d2 = (np.sum(e * e, -1)[:, None] + np.sum(q * q, -1)[None]
              - 2.0 * e @ q.T)
        d2 /= np.mean(q * q, -1)[None] * q.shape[-1]
        rel.append(np.sqrt(np.maximum(d2.min(axis=1), 0.0)))
        centre.append(np.abs(pts[lane, :topk, None]
                             - ref_out["centre"][lane, None]).max(-1)
                      .min(axis=1))
    rel, centre = np.concatenate(rel), np.concatenate(centre)
    return {"emb_med": float(np.median(rel)),
            "emb_p90": float(np.quantile(rel, 0.9)),
            "bank_centre_med": float(np.median(centre)),
            "bank_old_max": max(
                float(np.abs(bank[k][:, topk:] - ref_bank[k][:, topk:]).max())
                for k in bank)}


class Reservoir:
    """A uniform sample of ``size`` frames of a stream of unknown length
    among those ``eligible`` takes, each with the program's state going
    into it and the one coming out of it (reservoir sampling, so the window
    holds at most ``size`` pairs). ``offer`` comes before each frame's
    step() with the state going into it; ``close`` with the last state."""

    def __init__(self, rng, size: int, eligible):
        self.rng, self.size, self.eligible = rng, size, eligible
        self.seen = 0
        self.items = []         # [index, state in, state out]

    def offer(self, i: int, state):
        for item in self.items:
            if item[0] == i - 1:
                item[2] = state
        if not self.eligible(i):
            return
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append([i, state, None])
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = [i, state, None]

    def close(self, i_last: int, state):
        for item in self.items:
            if item[0] == i_last:
                item[2] = state


def run_reference(sd, cfg, stream, device, frames, outputs, batch,
                  bank_of):
    """Numbers of every compared frame. frames: [index, program state in,
    program state out] of the sampled frames; outputs: the program's host
    boxes by window index; bank_of: a state's memory bank by field name. A
    scene start runs from an empty bank, any other frame from the bank the
    program carried into it. Returns [(index, kind, numbers)]."""
    import torch
    from .reference import model as ref
    ref.set_plain_math()
    topk = cfg["head"]["topk_proposals"]

    def host(d):
        return {n: v.double().cpu().numpy() for n, v in d.items()}

    res = []
    with torch.no_grad():
        for i, s_in, s_out in frames:
            if i not in outputs or s_out is None:
                continue
            fr = {n: v.to(device) for n, v in stream.frame(i).items()}
            start = float(fr["prev_exists"].max()) == 0.0
            bank = ref.empty_bank(cfg, batch, device) if start \
                else bank_of(s_in)
            out, own = ref.frame_forward(sd, cfg, fr, bank)
            out = host(out)
            nums = frame_numbers(outputs[i], out["logits"], out["boxes"])
            nums.update(bank_numbers(host(bank_of(s_out)), out, host(own),
                                     topk))
            res.append((i, "scene start" if start else "mid-scene", nums))
    return res
