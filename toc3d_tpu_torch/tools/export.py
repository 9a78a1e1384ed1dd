"""Export the streaming detector as ``torch.export`` programs (twin of
tools/export.py; runtime/export.py holds the format):

    python3 -m toc3d_tpu_torch.tools.export --config ToC3D_faster_1600 \\
        --out export/faster_1600 [--checkpoint ckpt.pth] [--batch 1] \\
        [--views 6] [--int8 [--int8-calib N]] [--uint8-img] [--selfcheck] \\
        [--device cuda]

The artifact runs where it was exported: on the card by default (``--device
cpu`` for a CPU artifact, for tests); without a card the default device
raises, nothing falls back to the CPU. An f32 config (such as ``tiny``) is
served in bf16 on the card, as the eval does. ``--checkpoint x.pth`` loads
a reference checkpoint (convert.load_reference_checkpoint); without one the
weights are random (seed 0). ``--int8``: backbone and decoder quant 'int8'
(B8, C8, H8), dynamic activation scales, or static ones calibrated on N
synthetic frames with ``--int8-calib N``. ``--uint8-img``: the programs
take raw uint8 frames, normalized on the device.

``--selfcheck`` reloads the artifact and streams 3 frames (the first, then
two steady ones) through its call (captured graphs on the card), through
its eager run and through ``make_infer_fn`` in this process; boxes,
scores, labels, validity and the memory bank of both must equal
make_infer_fn's bit for bit, else the exit code is 1. Prints one JSON
line: the export's seconds and the artifact's bytes by file.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a reference (mmdet3d) .pth; random weights without")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="export the int8 serving path (backbone blocks and "
                         "decoder linears quantized once at export)")
    ap.add_argument("--int8-calib", type=int, default=0,
                    help="with --int8: static activation scales calibrated "
                         "on this many synthetic frames (0: dynamic)")
    ap.add_argument("--uint8-img", action="store_true",
                    help="export the raw-uint8 frame program (normalized on "
                         "the device)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="reload the artifact and hold it to make_infer_fn "
                         "bit for bit on 3 streaming frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.int8_calib and not args.int8:
        ap.error("--int8-calib requires --int8")
    return args


def selfcheck(model, out: str, batch: int, views: int, uint8: bool,
              device) -> bool:
    """Stream 3 frames (prev_exists 0, 1, 1) through the reloaded artifact,
    its call (captured graphs on CUDA) and its eager run, and through
    make_infer_fn(model); True when both give every output and the bank
    equal bit for bit to make_infer_fn's. Prints one line a frame."""
    import numpy as np
    import torch
    from ..bench import make_frame
    from ..models.detector import init_state, make_infer_fn
    from ..runtime.export import load_detector
    det = load_detector(out, device)
    ref = make_infer_fn(model)
    s_exp, s_eag = det.init_state(), det.init_state()
    s_ref = init_state(batch, model.cfg, device=device)
    h, w = model.cfg.pad_shape
    rng = np.random.RandomState(0)
    ok = True
    for i in range(3):
        frame = make_frame(rng, batch, views, h, w, float(i > 0), False)
        if not uint8:
            frame["img"] = torch.from_numpy(
                rng.randn(batch, views, h, w, 3).astype(np.float32))
        s_exp, d_exp = det(s_exp, frame)
        s_eag, d_eag = det.eager(s_eag, frame)
        s_ref, d_ref = ref(s_ref, frame)
        want = tuple(d_ref) + tuple(s_ref.memory)
        same = {run: [torch.equal(a, b) for a, b in zip(
            tuple(d) + tuple(s.memory), want)]
            for run, d, s in (("call", d_exp, s_exp),
                              ("eager", d_eag, s_eag))}
        ok &= all(same["call"]) and all(same["eager"])
        print(f"# frame {i}: exported equals make_infer_fn "
              f"(boxes, scores, labels, valid, bank): call {same['call']}, "
              f"eager {same['eager']}", flush=True)
    print(f"# selfcheck {'OK (bit-identical)' if ok else 'FAILED'}",
          flush=True)
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    from ..bench import make_frame
    from ..configs import apply_overrides, get_config
    from ..configs.presets import served_in_bf16
    from ..models.detector import build_detector, frame_to_device
    from ..ops.int8_calib import attach_act_scales, calibrate_act_scales
    from ..runtime.export import export_detector

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the export runs on the card "
                           "(pass --device cpu for a CPU artifact)")
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    if cuda and cfg.compute_dtype != "bfloat16":
        cfg = served_in_bf16(cfg)
    if args.int8:
        cfg = replace(cfg, backbone=replace(cfg.backbone, quant="int8"),
                      head=replace(cfg.head, decoder=replace(
                          cfg.head.decoder, quant="int8")))
    if args.checkpoint:
        from ..convert import load_reference_checkpoint
        model = build_detector(cfg, device=device, state_dict=(
            load_reference_checkpoint(args.checkpoint)))
    else:
        print("WARNING: no checkpoint — exporting random weights")
        model = build_detector(cfg, device=device, seed=0)
    h, w = cfg.pad_shape
    if args.int8_calib:
        rng = np.random.RandomState(7)
        cal = [frame_to_device(make_frame(rng, args.batch, args.views, h, w,
                                          float(i > 0), False), device)
               for i in range(args.int8_calib)]
        with torch.no_grad():
            attach_act_scales(model, calibrate_act_scales(model, cal))

    t0 = time.perf_counter()
    manifest = export_detector(
        model, args.out, batch_size=args.batch, num_views=args.views,
        img_dtype=torch.uint8 if args.uint8_img else torch.float32)
    export_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(args.out, f))
             for f in sorted(os.listdir(args.out))}
    print(json.dumps({"out": args.out, "device": manifest["device"],
                      "ops": manifest["ops"], "export_s": export_s,
                      "artifact_bytes": sizes}), flush=True)
    if args.selfcheck and not selfcheck(model, args.out, args.batch,
                                        args.views, args.uint8_img, device):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
