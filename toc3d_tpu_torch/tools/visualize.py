"""Detections drawn for inspection (twin of tools/visualize.py): GT and
predicted box wireframes on each camera image, a top-down BEV panel, and a
render_sample-style composite per sample (the reference's tools/
visualize.py + visual_nuscenes.py, whose driven entry point is the devkit's
NuScenes.render_sample(token): every camera tiled beside the top-down
view with the predictions drawn over them).

    python3 -m toc3d_tpu_torch.tools.visualize \\
        --results work_dirs/eval/results_nusc.json \\
        --ann data/nuscenes/nuscenes2d_temporal_infos_val.pkl \\
        --data-root data/nuscenes --out-dir vis --num-samples 20 \\
        [--score-thresh 0.3] [--no-gt] [--no-cams] [--bev-range 55] \\
        [--composite]

Without the devkit; PIL, imported where an image is drawn. Host-only: no
device is involved.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.convert import _box_corners
from ..data.nuscenes import quaternion_rotation_matrix

EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
COLORS = {
    "car": (255, 158, 0), "truck": (255, 99, 71), "bus": (255, 69, 0),
    "trailer": (255, 140, 0), "construction_vehicle": (233, 150, 70),
    "pedestrian": (0, 0, 230), "motorcycle": (255, 61, 99),
    "bicycle": (220, 20, 60), "traffic_cone": (47, 79, 79),
    "barrier": (112, 128, 144),
}
GT_COLOR = (0, 200, 0)


def draw_wireframe(draw, intr, g2c_r, c2g_t, anno, color, width=2):
    center = g2c_r @ (np.asarray(anno["translation"]) - c2g_t)
    if center[2] < 0.5:
        return
    rot_in_cam = g2c_r @ quaternion_rotation_matrix(
        np.asarray(anno["rotation"]))
    corners = _box_corners(center, anno["size"], rot_in_cam)
    if (corners[2] < 0.1).any():
        return
    uv = intr @ corners
    uv = (uv[:2] / uv[2]).T
    for e0, e1 in EDGES:
        draw.line([tuple(uv[e0]), tuple(uv[e1])], fill=color, width=width)


def bev_corners(anno):
    """4 ground-plane corners of a global-frame box, (4, 2) xy."""
    w, l, h = anno["size"]
    rot = quaternion_rotation_matrix(np.asarray(anno["rotation"]))
    x = l / 2 * np.array([1, 1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1])
    pts = rot[:2, :2] @ np.stack([x, y]) + np.asarray(
        anno["translation"])[:2, None]
    return pts.T


def render_bev(info, pred_annos, gt_annos, bev_range=55.0, size=800):
    """Ego-centred top-down panel (visual_nuscenes render BEV equivalent):
    GT green, predictions class-coloured, heading tick on each box."""
    from PIL import Image, ImageDraw
    e2g_r = quaternion_rotation_matrix(info["ego2global_rotation"])
    e2g_t = np.asarray(info["ego2global_translation"])
    g2e_r = e2g_r.T

    img = Image.new("RGB", (size, size), (20, 20, 20))
    draw = ImageDraw.Draw(img)
    scale = size / (2 * bev_range)

    def px(pt_ego):
        return (size / 2 + pt_ego[0] * scale, size / 2 - pt_ego[1] * scale)

    # range rings every 10 m
    for r in range(10, int(bev_range) + 1, 10):
        bbox = [px((-r, r)), px((r, -r))]
        draw.ellipse([bbox[0][0], bbox[0][1], bbox[1][0], bbox[1][1]],
                     outline=(60, 60, 60))
    # ego marker
    draw.polygon([px((0, 1.5)), px((-0.8, -1)), px((0.8, -1))],
                 fill=(255, 255, 255))

    def draw_boxes(annos, color_fn, width):
        for a in annos:
            corners_g = bev_corners(a)                       # (4, 2) global
            corners_e = (g2e_r[:2, :2] @ (corners_g - e2g_t[:2]).T).T
            if np.abs(corners_e).max() > bev_range * 1.2:
                continue
            pts = [px(c) for c in corners_e]
            draw.polygon(pts, outline=color_fn(a), width=width)
            # heading tick: center -> midpoint of the front edge
            center_e = corners_e.mean(axis=0)
            front = (corners_e[0] + corners_e[1]) / 2
            draw.line([px(center_e), px(front)], fill=color_fn(a),
                      width=width)

    draw_boxes(gt_annos, lambda a: GT_COLOR, 2)
    draw_boxes(pred_annos,
               lambda a: COLORS.get(a["detection_name"], (0, 160, 255)), 1)
    return img


def render_camera(info, cam, annos, gt_annos, data_root=None,
                  score_labels=True):
    """One camera image with GT (green) + prediction wireframes and
    class/score labels (visual_nuscenes render_sample per-camera axes)."""
    from PIL import Image, ImageDraw
    path = cam["data_path"]
    if data_root and not path.startswith("/"):
        path = os.path.join(data_root, path.lstrip("./"))
    img = Image.open(path).convert("RGB")
    draw = ImageDraw.Draw(img)
    intr = np.asarray(cam["cam_intrinsic"], np.float64)[:3, :3]
    # global -> cam via lidar (keys present in every pkl flavor):
    # cam2global = ego2global @ lidar2ego @ cam2lidar
    e2g_r = quaternion_rotation_matrix(info["ego2global_rotation"])
    e2g_t = np.asarray(info["ego2global_translation"])
    l2e_r = quaternion_rotation_matrix(info["lidar2ego_rotation"])
    l2e_t = np.asarray(info["lidar2ego_translation"])
    c2l_r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
    c2l_t = np.asarray(cam["sensor2lidar_translation"], np.float64)
    c2g_r = e2g_r @ l2e_r @ c2l_r
    c2g_t = e2g_r @ (l2e_r @ c2l_t + l2e_t) + e2g_t
    g2c_r = c2g_r.T
    for a in gt_annos:
        draw_wireframe(draw, intr, g2c_r, c2g_t, a, GT_COLOR, 2)
    for a in annos:
        color = COLORS.get(a["detection_name"], (0, 255, 0))
        draw_wireframe(draw, intr, g2c_r, c2g_t, a, color, 2)
        if score_labels:
            center = g2c_r @ (np.asarray(a["translation"]) - c2g_t)
            if center[2] < 0.5:
                continue
            uv = intr @ center
            u, v = float(uv[0] / uv[2]), float(uv[1] / uv[2])
            if 0 <= u < img.width and 0 <= v < img.height:
                draw.text((u + 3, v - 10),
                          f"{a['detection_name']} "
                          f"{a.get('detection_score', 0):.2f}", fill=color)
    return img


# devkit render_sample camera layout (top row / bottom row)
CAM_LAYOUT = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
              "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT")


def render_sample_composite(info, annos, gt_annos, data_root=None,
                            bev_range=55.0, tile_w=533):
    """render_sample-equivalent: all cameras tiled (canonical nuScenes
    layout when present, sorted order otherwise) + the BEV panel on the
    right + a class legend strip (visual_nuscenes.py:577-589)."""
    from PIL import Image, ImageDraw

    names = [c for c in CAM_LAYOUT if c in info["cams"]]
    if not names:
        names = sorted(info["cams"])
    cols = 3 if len(names) > 2 else max(1, len(names))
    rows = -(-len(names) // cols)

    tiles = []
    for name in names:
        img = render_camera(info, info["cams"][name], annos, gt_annos,
                            data_root)
        th = round(tile_w * img.height / img.width)
        tiles.append(img.resize((tile_w, th)))
    tile_h = min(t.height for t in tiles)
    grid_h = rows * tile_h
    bev = render_bev(info, annos, gt_annos, bev_range,
                     size=grid_h).resize((grid_h, grid_h))

    legend_h = 22
    canvas = Image.new("RGB", (cols * tile_w + grid_h, grid_h + legend_h),
                       (0, 0, 0))
    for i, t in enumerate(tiles):
        canvas.paste(t.crop((0, 0, tile_w, tile_h)),
                     ((i % cols) * tile_w, (i // cols) * tile_h))
    canvas.paste(bev, (cols * tile_w, 0))
    draw = ImageDraw.Draw(canvas)
    x = 6
    present = {a["detection_name"] for a in annos}
    entries = [("GT", GT_COLOR)] + [(c, COLORS[c]) for c in COLORS
                                    if c in present]
    for label, color in entries:
        draw.rectangle([x, grid_h + 6, x + 12, grid_h + 16], fill=color)
        draw.text((x + 16, grid_h + 4), label, fill=(230, 230, 230))
        x += 16 + 8 * len(label) + 14
    return canvas


def main(argv=None):
    """Render the first --num-samples samples into --out-dir."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out-dir", default="vis")
    ap.add_argument("--num-samples", type=int, default=20)
    ap.add_argument("--score-thresh", type=float, default=0.3)
    ap.add_argument("--no-gt", action="store_true",
                    help="skip the GT overlay (predictions only)")
    ap.add_argument("--no-cams", action="store_true",
                    help="render only the BEV panels")
    ap.add_argument("--composite", action="store_true",
                    help="one render_sample-style figure per sample "
                         "(tiled cameras + BEV + legend) instead of "
                         "separate images")
    ap.add_argument("--bev-range", type=float, default=55.0)
    args = ap.parse_args(argv)

    from ..data.nuscenes import NuScenesInfos
    from ..runtime.nusc_metrics import build_gt_from_infos

    with open(args.results) as f:
        preds = json.load(f)["results"]
    infos = NuScenesInfos(args.ann)
    os.makedirs(args.out_dir, exist_ok=True)

    n = min(args.num_samples, len(infos))
    gt_all = {}
    if not args.no_gt and "gt_boxes" in infos.infos[0]:
        gt_all = build_gt_from_infos(infos.infos[:n])

    for idx in range(n):
        info = infos.infos[idx]
        annos = [a for a in preds.get(info["token"], [])
                 if a["detection_score"] >= args.score_thresh]
        gt_annos = gt_all.get(info["token"], [])

        if args.composite:
            img = render_sample_composite(info, annos, gt_annos,
                                          args.data_root, args.bev_range)
            img.save(os.path.join(args.out_dir, f"{idx:04d}_sample.jpg"))
            if (idx + 1) % 5 == 0:
                print(f"{idx + 1} samples rendered")
            continue

        img = render_bev(info, annos, gt_annos, args.bev_range)
        img.save(os.path.join(args.out_dir, f"{idx:04d}_BEV.jpg"))

        if args.no_cams:
            continue
        for cam_name, cam in info["cams"].items():
            img = render_camera(info, cam, annos, gt_annos, args.data_root,
                                score_labels=False)
            img.save(os.path.join(args.out_dir,
                                  f"{idx:04d}_{cam_name}.jpg"))
        if (idx + 1) % 5 == 0:
            print(f"{idx + 1} samples rendered")


if __name__ == "__main__":
    main()
