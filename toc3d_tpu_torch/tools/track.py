"""Offline tracking on a detection submission (the twin of tools/track.py).

    python3 -m toc3d_tpu_torch.tools.track \\
        --results work_dirs/eval/results_nusc.json \\
        --ann data/nuscenes/nuscenes2d_temporal_infos_val.pkl \\
        --work-dir work_dirs/tracking [--hungarian] [--max-age 3] [--eval] \\
        [--device cuda]

Parity target: reference nusc_tracking/pub_test.py — builds frame metadata,
streams frames with per-scene tracker reset, writes tracking_result.json.
Frame metadata comes from the info pkl instead of the devkit. The tracker
and its metrics are host numpy, as in the JAX package; ``--device`` is the
port's entry-point convention (cuda unless the caller asks for the CPU, and
a missing card raises), and nothing of tracking runs on it.

``main(argv)`` returns the tracking result and, with ``--eval``, the
metrics.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--work-dir", default="work_dirs/tracking")
    ap.add_argument("--hungarian", action="store_true")
    ap.add_argument("--max-age", type=int, default=3)
    ap.add_argument("--score-threshold", type=float, default=0.25)
    ap.add_argument("--eval", action="store_true",
                    help="compute AMOTA/AMOTP with the internal devkit-free "
                         "tracking evaluator (tracking/metrics.py)")
    ap.add_argument("--strict-parity", action="store_true",
                    help="replicate the reference's empty-frame track "
                         "lifecycle exactly (see PubTracker docstring)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises")
    args = ap.parse_args(argv)

    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for a CPU "
                           "run)")

    from ..data.nuscenes import NuScenesInfos
    from ..tracking import track_detections
    from ..tracking.pub_tracker import (frames_from_infos,
                                        write_tracking_result)

    with open(args.results) as f:
        predictions = json.load(f)["results"]
    infos = NuScenesInfos(args.ann)
    frames = frames_from_infos(infos.infos)
    result = track_detections(predictions, frames, max_age=args.max_age,
                              score_threshold=args.score_threshold,
                              hungarian=args.hungarian,
                              strict_parity=args.strict_parity)
    path = write_tracking_result(result, args.work_dir)
    print(f"wrote {path} ({result['fps']:.1f} frames/s)")

    # official TrackingEval when the devkit is present (pub_test.py:165-183)
    try:
        from nuscenes.eval.tracking.evaluate import TrackingEval  # noqa
        print("nuscenes-devkit present; run TrackingEval against", path)
    except ImportError:
        pass

    out = {"path": path, "result": result}
    if args.eval:
        from ..tracking.metrics import (build_tracking_gt_from_infos,
                                        scenes_from_infos, evaluate_tracking)
        gt = build_tracking_gt_from_infos(infos.infos)
        scenes = scenes_from_infos(infos.infos)
        metrics = evaluate_tracking(gt, result["results"], scenes)
        print(json.dumps({
            "AMOTA": round(metrics["AMOTA"], 4),
            "AMOTP": round(metrics["AMOTP"], 4),
            "per_class": {c: {"amota": round(v["amota"], 4),
                              "amotp": round(v["amotp"], 4)}
                          for c, v in metrics["per_class"].items()},
            "evaluator": "internal"}))
        out["metrics"] = metrics
    return out


if __name__ == "__main__":
    main()
