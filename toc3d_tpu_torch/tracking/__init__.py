"""Tracking by detection and its metrics (a copy of toc3d_tpu/tracking)."""
from .pub_tracker import PubTracker, greedy_assignment, track_detections
