"""Frame and sample builders and the threaded prefetching loader
(counterpart of toc3d_tpu/data/loader.py: _load_image_bgr :24, _has_cv2
:32, _load_transform_fast :40, build_eval_frame :93, build_train_sample
:163, build_train_sequence :243, PrefetchIterator :263).

Frames are numpy dicts, as in the JAX package; ``detector.frame_to_device``
or the captured frame (runtime/graphs.CapturedInfer) moves them to the
card. Image IO is PIL, or cv2 where it is installed for the fast decode;
both are imported where an image is read. One background thread overlaps
the host's preprocessing with the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .nuscenes import (NuScenesInfos, AugConfig, sample_augmentation,
                       ida_matrix, transform_image, normalize_image,
                       pad_to_multiple, IMG_NORM_MEAN, filter_invisible,
                       global_rot_scale_trans, transform_boxes2d)
from .sampler import pad_gt_2d, pad_gt_3d


def _load_image_bgr(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    return rgb[..., ::-1]


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
        return True
    except ImportError:
        return False


def _load_transform_fast(path: str, resize_dims, crop, flip: bool):
    """Fused decode->resize->crop->flip -> (fH, fW, 3) uint8 BGR.

    JPEG decode happens at a DCT-domain power-of-2 reduction >= resize_dims
    (libjpeg scaled IDCT) — ~4x less IDCT+colorspace work than full decode
    for the 800x320 pipeline (the 1600x900 source halves to 800x450 inside
    the decoder). Decoder is cv2 when available (libjpeg-turbo, emits BGR
    directly — no channel flip copy) with a PIL `draft` fallback. Output
    stays uint8: normalization belongs on the device (see
    detector.extract_img_feat), where (x-mean)/std fuses into the backbone
    program for free and the host->device transfer shrinks 4x.

    Pixel values differ slightly from the exact path (bilinear from the
    reduced scale vs bicubic from full resolution), so this is opt-in
    (fast_decode) for speed runs / production serving, not the
    parity-tested default."""
    tw, th = resize_dims
    if _has_cv2():
        import cv2
        from PIL import Image

        with Image.open(path) as im:           # lazy: header only
            sw, sh = im.size
        k = 1
        while k < 8 and sw // (2 * k) >= tw and sh // (2 * k) >= th:
            k *= 2
        flag = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
                4: cv2.IMREAD_REDUCED_COLOR_4,
                8: cv2.IMREAD_REDUCED_COLOR_8}[k]
        img = cv2.imread(path, flag)                         # (h, w, 3) BGR
        if img is None:                                      # exotic format
            img = _load_image_bgr(path)
        if (img.shape[1], img.shape[0]) != (tw, th):
            img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
        left, upper, right, lower = crop
        img = img[upper:lower, left:right]
        if flip:
            img = img[:, ::-1]
        return np.ascontiguousarray(img)

    from PIL import Image

    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("RGB", resize_dims)
        pil = im.convert("RGB").resize(resize_dims)
    pil = pil.crop(crop)
    if flip:
        pil = pil.transpose(method=Image.FLIP_LEFT_RIGHT)
    out = np.asarray(pil, np.uint8)[..., ::-1]               # BGR
    return np.ascontiguousarray(out)


def build_eval_frame(infos: NuScenesInfos, index: int, aug: AugConfig,
                     data_root: Optional[str] = None,
                     fast_decode: bool = False,
                     device_normalize: bool = False) -> Dict:
    """Deterministic eval preprocessing for one sample -> numpy frame dict
    (B=1 leading axis) + meta for submission formatting. fast_decode uses
    reduced-scale JPEG decoding (see _load_transform_fast).

    device_normalize (requires fast_decode): emit frame['img'] as raw
    uint8 BGR and let the backbone apply (x-mean)/std on the device
    (detector.extract_img_feat) — 4x less host->device transfer and zero
    host normalize cost; numerically identical math."""
    if device_normalize and not fast_decode:
        raise ValueError("device_normalize needs the uint8 fast_decode "
                         "payload; the exact path is float after resize")
    meta = infos.frame_meta(index)
    resize, resize_dims, crop, flip = sample_augmentation(aug, training=False)
    ida = ida_matrix(resize, crop, flip)

    imgs, intrinsics, lidar2img = [], [], []
    for path, intr, extr in zip(meta["img_paths"], meta["intrinsics"],
                                meta["extrinsics"]):
        if data_root is not None and not path.startswith("/"):
            path = f"{data_root.rstrip('/')}/{path.lstrip('./')}"
        if fast_decode:
            img = _load_transform_fast(path, resize_dims, crop, flip)
            if not device_normalize:
                img = normalize_image(img.astype(np.float32))
        else:
            img = _load_image_bgr(path)
            img = normalize_image(transform_image(img, resize_dims, crop,
                                                  flip))
        # uint8 payloads pad with the mean pixel so the device-side
        # (x-mean)/std maps padding to ~0, matching host-normalized padding
        img = pad_to_multiple(
            img, 32,
            fill=(np.round(IMG_NORM_MEAN) if img.dtype == np.uint8
                  else None))
        imgs.append(img)
        intr = intr.copy()
        intr[:3, :3] = ida @ intr[:3, :3]
        intrinsics.append(intr)
        lidar2img.append(intr @ extr)

    img_stack = np.stack(imgs)[None]
    frame_img = (img_stack if img_stack.dtype == np.uint8
                 else img_stack.astype(np.float32))
    img2lidar = [np.linalg.inv(m).astype(np.float32) for m in lidar2img]
    frame = {
        "img": frame_img,
        "intrinsics": np.stack(intrinsics)[None].astype(np.float32),
        "lidar2img": np.stack(lidar2img)[None].astype(np.float32),
        "img2lidar": np.stack(img2lidar)[None],
        "timestamp": np.asarray([meta["timestamp"]], np.float32),
        "ego_pose": meta["ego_pose"][None],
        "ego_pose_inv": meta["ego_pose_inv"][None],
        "prev_exists": np.zeros((1,), np.float32),  # set by streaming loop
    }
    info = infos.infos[index]
    fmt_meta = {
        "token": info["token"],
        "scene_token": info["scene_token"],
        "lidar2ego_rotation": info["lidar2ego_rotation"],
        "lidar2ego_translation": info["lidar2ego_translation"],
        "ego2global_rotation": info["ego2global_rotation"],
        "ego2global_translation": info["ego2global_translation"],
    }
    return frame, fmt_meta


def build_train_sample(infos: NuScenesInfos, index: int, aug: AugConfig,
                       rng: np.random.RandomState, max_gt_3d: int = 96,
                       max_gt_2d: int = 64,
                       data_root: Optional[str] = None,
                       pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)) -> Dict:
    """One augmented training sample (no batch axis) with padded GT, in
    the train pipeline's order (ToC3D_fast.py:186-205): range and name
    filter, ResizeCropFlipRot with the 2D GT, GlobalRotScaleTrans,
    normalize, pad (loader.py:163-240)."""
    from ..core.boxes import in_range_bev, limit_yaw
    meta = infos.frame_meta(index)
    ann = infos.annotations(index)
    boxes3d, labels3d = ann["gt_bboxes_3d"], ann["gt_labels_3d"]
    keep = in_range_bev(boxes3d, (pc_range[0], pc_range[1], pc_range[3],
                                  pc_range[4])) & (labels3d >= 0)
    boxes3d, labels3d = boxes3d[keep], labels3d[keep]
    boxes3d = limit_yaw(boxes3d, offset=0.5, period=2 * np.pi)

    resize, resize_dims, crop, flip = sample_augmentation(aug, training=True,
                                                          rng=rng)
    ida = ida_matrix(resize, crop, flip)
    imgs, intrinsics = [], []
    b2d, l2d, c2d = [], [], []
    for v, (path, intr) in enumerate(zip(meta["img_paths"],
                                         meta["intrinsics"])):
        if data_root is not None and not path.startswith("/"):
            path = f"{data_root.rstrip('/')}/{path.lstrip('./')}"
        imgs.append(transform_image(_load_image_bgr(path), resize_dims, crop,
                                    flip))
        intr = intr.copy()
        intr[:3, :3] = ida @ intr[:3, :3]
        intrinsics.append(intr)
        bb = ann["bboxes2d"][v].copy()
        cc = ann["centers2d"][v].copy()
        ll = ann["labels2d"][v].copy()
        dd = ann["depths"][v].copy()
        if len(bb):
            bb, cc, ll, dd = transform_boxes2d(bb, cc, ll, dd, resize, crop,
                                               flip, aug.final_dim)
        if len(bb):
            bb, cc, ll, dd = filter_invisible(bb, cc, ll, dd, aug.final_dim)
        b2d.append(bb)
        l2d.append(ll)
        c2d.append(cc)

    meta["lidar2img"] = [i @ e for i, e in zip(intrinsics,
                                               meta["extrinsics"])]
    meta, boxes3d = global_rot_scale_trans(meta, boxes3d, rng)
    imgs = [pad_to_multiple(normalize_image(im), 32) for im in imgs]
    img2lidar = [np.linalg.inv(m).astype(np.float32)
                 for m in meta["lidar2img"]]
    gb3, gl3, gv3 = pad_gt_3d(boxes3d, labels3d, max_gt_3d)
    gb2, gl2, gc2, gv2 = pad_gt_2d(b2d, l2d, c2d, max_gt_2d)
    return {
        "img": np.stack(imgs).astype(np.float32),
        "intrinsics": np.stack(intrinsics).astype(np.float32),
        "lidar2img": np.stack(meta["lidar2img"]).astype(np.float32),
        "img2lidar": np.stack(img2lidar),
        "timestamp": np.float32(meta["timestamp"]),
        "ego_pose": meta["ego_pose"].astype(np.float32),
        "ego_pose_inv": meta["ego_pose_inv"].astype(np.float32),
        "prev_exists": np.float32(infos.prev_exists(index)),
        "gt_bboxes_3d": gb3,
        "gt_labels_3d": gl3,
        "gt_valid_3d": gv3,
        "gt_bboxes_2d": gb2,
        "gt_labels_2d": gl2,
        "gt_centers_2d": gc2,
        "gt_valid_2d": gv2,
    }


def build_train_sequence(infos: NuScenesInfos, index: int, queue_length: int,
                         aug: AugConfig, rng: np.random.RandomState,
                         **kw) -> Dict:
    """Frames [index - queue_length + 1 .. index] stacked on a T axis, each
    one's prev_exists from scene continuity (nuscenes_dataset.py:99-133,
    loader.py:243-260)."""
    idxs = [max(0, i) for i in range(index - queue_length + 1, index + 1)]
    samples = []
    prev_scene = None
    for i in idxs:
        s = build_train_sample(infos, i, aug, rng, **kw)
        scene = infos.infos[i]["scene_token"]
        s["prev_exists"] = np.float32(scene == prev_scene)
        prev_scene = scene
        samples.append(s)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchIterator:
    """Background-thread prefetch over any sample iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:   # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
