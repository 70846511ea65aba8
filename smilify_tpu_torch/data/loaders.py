"""Sequence loaders for the optimization fitter (port of
``smilify_tpu/data/loaders.py``).

Host-side numpy equivalents of the reference ``smal_fitter/data_loader.py``:
  * :func:`load_smil_sequence` — replicAnt COCO labels.json + ID-mask pngs
    (data_loader.py:123-231), with joint-name mapping against the model's
    ``J_names`` and the (y, x) flip;
  * :func:`load_badja_sequence` — BADJA joint_annotations json + segmentations
    (data_loader.py:17-65);
  * :func:`load_stanford_sequence` — StanfordExtra single images with RLE
    segmentations (data_loader.py:68-120);
  * :func:`crop_to_silhouette` — pad ×4, crop the 1.05× square around the
    silhouette bbox, resize, rescale joints (smal_fitter/utils.py:7-50).

Images are read by :func:`~smilify_tpu_torch.utils.image_io.read_image`
(PNG without imageio; other formats need imageio) and resized by
:func:`~smilify_tpu_torch.utils.image_io.resize` (cv2.resize's nearest and
linear modes without OpenCV). The polygon masks (``alt_seg=False``) import
matplotlib when used.

Outputs are channel-last float numpy arrays: rgb (N, H, W, 3) in [0, 1],
sil (N, H, W), joints (N, K, 2) in (row, col), visibility (N, K).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

from smilify_tpu_torch.utils.image_io import read_image, resize


def crop_to_silhouette(sil_img: np.ndarray, rgb_img: np.ndarray, joints: np.ndarray, target_size: int):
    """Crop a square (1.05× the silhouette bbox) and resize to target_size."""
    sil_h, sil_w = sil_img.shape
    pad_sil = np.zeros((sil_h * 4, sil_w * 4), dtype=sil_img.dtype)
    pad_rgb = np.ones((sil_h * 4, sil_w * 4, 3), dtype=rgb_img.dtype)
    pad_sil[sil_h * 2 : sil_h * 3, sil_w * 2 : sil_w * 3] = sil_img
    pad_rgb[sil_h * 2 : sil_h * 3, sil_w * 2 : sil_w * 3] = rgb_img

    fg = np.where(pad_sil > 0)
    y_min, y_max = fg[0].min(), fg[0].max()
    x_min, x_max = fg[1].min(), fg[1].max()

    half = int(1.05 * (max(x_max - x_min, y_max - y_min) / 2))
    cy = y_min + int((y_max - y_min) / 2)
    cx = x_min + int((x_max - x_min) / 2)

    sq_sil = pad_sil[cy - half : cy + half, cx - half : cx + half]
    sq_rgb = pad_rgb[cy - half : cy + half, cx - half : cx + half]

    sil_r = resize(sq_sil, (target_size, target_size), "nearest")
    rgb_r = resize(sq_rgb, (target_size, target_size), "linear")

    scaled = np.zeros_like(joints, dtype=np.float64)
    scaled[:, 0] = joints[:, 0] + (sil_h * 2) - (cy - half)
    scaled[:, 1] = joints[:, 1] + (sil_w * 2) - (cx - half)
    scaled = scaled * (target_size / (half * 2.0))
    return sil_r, rgb_r, scaled


def load_smil_sequence(
    coco_dir: str,
    image_name: str,
    crop_size: int,
    joint_names: Sequence[str],
    ignore_joints: Iterable[str] = (),
    alt_seg: bool = True,
    use_crop: bool = False,
):
    """Load a replicAnt COCO-format sample (reference load_SMIL_sequence).

    Joint keypoints are re-ordered into the model's ``joint_names`` order; ID
    masks come from the sibling ``SMIL/`` folder's ``*_ID.png`` red channel.
    """
    img_dir = os.path.join(coco_dir, "data")
    with open(os.path.join(coco_dir, "labels.json")) as f:
        meta = json.load(f)

    images = {e["file_name"]: e for e in meta["images"]}
    anns = {a["image_id"]: a for a in meta["annotations"]}
    entry = images[image_name]
    ann = anns[entry["id"]]

    rgb = read_image(os.path.join(img_dir, entry["file_name"])).astype(np.float64) / 255.0
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    rgb = rgb[..., :3]

    if alt_seg:
        mask_name = entry["file_name"][:-9] + "ID.png"
        mask_path = os.path.join(Path(img_dir).parent.parent, "SMIL", mask_name)
        seg = read_image(mask_path)[:, :, 0]
    else:
        from matplotlib.path import Path as MplPath

        h, w = entry["height"], entry["width"]
        seg = np.zeros((h, w), dtype=np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        pix = np.stack([xx.ravel(), yy.ravel()], axis=1)
        for poly in ann["segmentation"]:
            coords = np.asarray(poly).reshape(-1, 2)
            inside = MplPath(coords).contains_points(pix).reshape(h, w)
            seg[inside] = 1

    raw = np.asarray(ann["keypoints"], dtype=np.float64).reshape(-1, 3)
    kp_names = meta["categories"][0]["keypoints"]
    ignore = set(ignore_joints)

    K = len(joint_names)
    joints = np.zeros((K, 2), dtype=np.float64)
    visibility = np.zeros((K,), dtype=np.float64)
    for o, name in enumerate(joint_names):
        for m, mapped in enumerate(kp_names):
            if name == mapped:
                visibility[o] = 0.0 if name in ignore else raw[m, 2]
                joints[o] = [raw[m, 1], raw[m, 0]]  # (y, x)

    if use_crop:
        seg, rgb, joints = crop_to_silhouette(seg.astype(np.float64), rgb, joints, crop_size)

    sil = (np.asarray(seg) > 0).astype(np.float32)
    return (
        rgb[None].astype(np.float32),
        sil[None],
        joints[None].astype(np.float32),
        visibility[None].astype(np.float32),
    ), [os.path.basename(image_name)]


def load_badja_sequence(
    badja_path: str,
    sequence_name: str,
    crop_size: int,
    annotated_classes: Sequence[int],
    image_range: Optional[Sequence[int]] = None,
):
    """Load a BADJA dog-video sequence (reference load_badja_sequence)."""
    json_path = os.path.join(badja_path, "joint_annotations", f"{sequence_name}.json")
    with open(json_path) as f:
        seq = json.load(f)
    if image_range is not None:
        seq = [seq[i] for i in image_range]

    rgbs, sils, joints_l, vis_l, names = [], [], [], [], []
    cls = np.asarray(annotated_classes)
    for ann in seq:
        img_path = os.path.join(badja_path, ann["image_path"])
        seg_path = os.path.join(badja_path, ann["segmentation_path"])
        if not (os.path.exists(img_path) and os.path.exists(seg_path)):
            continue
        rgb = read_image(img_path).astype(np.float64) / 255.0
        sil = read_image(seg_path)[:, :, 0].astype(np.float64) / 255.0
        sil = resize(sil, rgb.shape[:2], "nearest")
        landmarks = np.asarray(ann["joints"])[cls]
        vis = np.asarray(ann["visibility"])[cls].astype(np.float64)
        sil, rgb, landmarks = crop_to_silhouette(sil, rgb, landmarks, crop_size)
        vis[cls == -1] = 0.0
        rgbs.append(rgb)
        sils.append(sil)
        joints_l.append(landmarks)
        vis_l.append(vis)
        names.append(os.path.basename(ann["image_path"]))

    return (
        np.stack(rgbs).astype(np.float32),
        np.stack(sils).astype(np.float32),
        np.stack(joints_l).astype(np.float32),
        np.stack(vis_l).astype(np.float32),
    ), names


def load_stanford_sequence(stanford_path: str, image_name: str, crop_size: int):
    """Load a StanfordExtra single-dog sample (reference load_stanford_sequence).

    RLE masks are decoded with a pure-python COCO RLE decoder (no pycocotools).
    """
    with open(os.path.join(stanford_path, "StanfordExtra_sample.json")) as f:
        data = {e["img_path"]: e for e in json.load(f)}
    entry = data[image_name]

    rgb = read_image(os.path.join(stanford_path, "sample_imgs", image_name)).astype(np.float64) / 255.0
    seg = _decode_coco_rle(entry["seg"], entry["img_height"], entry["img_width"]).astype(np.float64)

    raw = np.concatenate([np.asarray(entry["joints"]), [[0.0, 0.0, 0.0]]], axis=0)
    sil, rgb, landmarks = crop_to_silhouette(seg, rgb, raw[:, [1, 0]], crop_size)
    return (
        rgb[None].astype(np.float32),
        sil[None].astype(np.float32),
        landmarks[None, :, :2].astype(np.float32),
        raw[None, :, 2].astype(np.float32),
    ), [os.path.basename(image_name)]


def _decode_coco_rle(counts, h: int, w: int) -> np.ndarray:
    """Decode COCO compressed RLE (LEB128-style string) to a (h, w) mask."""
    if isinstance(counts, list):
        runs = counts
    else:
        s = counts.encode() if isinstance(counts, str) else counts
        runs = []
        i = 0
        while i < len(s):
            x = 0
            k = 0
            more = True
            while more:
                c = s[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(runs) > 2:
                x += runs[-2]
            runs.append(x)
    mask = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for run in runs:
        mask[pos : pos + run] = val
        pos += run
        val = 1 - val
    return mask.reshape(w, h).T  # COCO RLE is column-major
