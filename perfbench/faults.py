"""Faults planted under the timed path, each a function of the entry point
that returns the one to drive. The comparison has to read a run with any
of them as not correct: perfbench/tests at tiny sizes on the CPU, and
``perfbench.calibrate --fault NAME`` at a cell's own size on the card."""
from __future__ import annotations


def state_unchanged(infer):
    """Every step returns the state it was given."""
    def step(state, frame):
        _, det = infer(state, frame)
        return state, det
    return step


def answer_altered(infer):
    """Every frame's boxes 5% off in every field, where they are
    produced."""
    def step(state, frame):
        state, det = infer(state, frame)
        return state, det._replace(bboxes=det.bboxes * 1.05)
    return step


FAULTS = {"state_unchanged": state_unchanged,
          "answer_altered": answer_altered}
