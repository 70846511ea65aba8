"""The port's OpenCV paths on seeded inputs, for holding one machine's OpenCV
to another's.

    python -m smilify_tpu_torch.tools.opencv_paths --out tests/fixtures/opencv_paths.npz

:func:`run` feeds one seeded synthetic image (48 × 64 RGB, float32 in
[0, 1], and its uint8 copy), camera and keypoints through the host paths that
call OpenCV:

* ``data/augmentation.py``: ``photometric_augment`` with the blur forced on
  (``cv2.GaussianBlur``, kernels 3-7) for two draws, the single-view
  training path (``AugmentedDataset`` over a one-sample dataset, with the
  training config's default parameters), and ``geometric_scale_jitter`` /
  ``geometric_crop_jitter`` (``cv2.warpAffine``) with their intrinsics and
  keypoints;
* ``data/preprocess_multiview.py::undistort_view`` (``cv2.undistort`` and
  ``cv2.undistortPoints``) and ``data/sleap.py::CameraCalibration.undistort_points``
  with five distortion coefficients.

``--out`` writes the arrays as an npz; ``tests/fixtures/opencv_paths.npz`` is
that file from the CPU the tests run on, and ``chip_smoke.py`` holds the card
machine's OpenCV to it.

OpenCV 4 and 5 warp float images differently: 4.x samples at the source
position rounded to 1/32 pixel (``INTER_BITS`` = 5), 5.0 at the exact
position, so near an edge the two differ by more than a grey level.
:func:`warp_affine_reference` computes either in numpy, from the two warps'
matrices (``warp_matrices``).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

H, W = 48, 64
DIST = np.array([-0.21, 0.06, 0.0012, -0.0008, -0.01])


def inputs(seed: int = 0):
    """(image float32 (H, W, 3) in [0, 1], K (3, 3), keypoints (12, 2) pixel x, y)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
    img = np.stack([x, y, 0.5 + 0.5 * np.sin(6 * x + 4 * y)], -1)
    img[15:30, 20:45] = [0.9, 0.2, 0.1]
    img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1).astype(np.float32)
    K = np.array([[75.0, 0, W / 2 - 1.5], [0, 74.0, H / 2 + 1.0], [0, 0, 1]])
    kp = rng.uniform([3, 3], [W - 3, H - 3], (12, 2))
    return img, K, kp


def warp_affine_reference(img: np.ndarray, M: np.ndarray, subpixel_bits=None) -> np.ndarray:
    """``cv2.warpAffine(img, M, (W, H), flags=INTER_LINEAR, borderMode=BORDER_REPLICATE)``
    of a float image in numpy: each output pixel bilinear at the source
    position ``M⁻¹ (x, y)``, that position rounded to 1/2**``subpixel_bits``
    pixel (OpenCV 4: 5) or exact (``None``: OpenCV 5)."""
    A, b = M[:, :2], M[:, 2]
    Ai = np.linalg.inv(A)
    H, W = img.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    X = Ai[0, 0] * (xs - b[0]) + Ai[0, 1] * (ys - b[1])
    Y = Ai[1, 0] * (xs - b[0]) + Ai[1, 1] * (ys - b[1])
    if subpixel_bits is not None:
        q = float(2 ** subpixel_bits)
        X, Y = np.round(X * q) / q, np.round(Y * q) / q
    x0, y0 = np.floor(X).astype(int), np.floor(Y).astype(int)
    fx, fy = (X - x0)[..., None], (Y - y0)[..., None]

    def at(yy, xx):
        return img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(np.float64)

    out = ((1 - fx) * (1 - fy) * at(y0, x0) + fx * (1 - fy) * at(y0, x0 + 1)
           + (1 - fx) * fy * at(y0 + 1, x0) + fx * fy * at(y0 + 1, x0 + 1))
    return out.astype(img.dtype)


def run(seed: int = 0) -> Dict[str, np.ndarray]:
    from smilify_tpu_torch.data.augmentation import (
        AugmentationParams,
        AugmentedDataset,
        geometric_crop_jitter,
        geometric_scale_jitter,
        params_from_config,
        photometric_augment,
    )
    from smilify_tpu_torch.data.preprocess_multiview import undistort_view
    from smilify_tpu_torch.data.sleap import CameraCalibration
    from smilify_tpu_torch.train.config import load_config

    img, K, kp = inputs(seed)
    out = {}
    blur = AugmentationParams(gaussian_blur_prob=1.0, random_erasing_prob=0.0)
    for i in range(2):
        out[f"blurred_{i}"] = photometric_augment(img, np.random.default_rng((seed, i)), blur)
    cfg = load_config(None, overrides={"augmentation.enabled": True}, mode="single_view")
    aug = AugmentedDataset([{"image": img}], params_from_config(cfg.augmentation), seed=seed,
                           multiview=False)
    for epoch in range(2):
        aug.set_epoch(epoch)
        out[f"singleview_epoch_{epoch}"] = aug[0]["image"]
    geo = AugmentationParams(geometric_enabled=True, crop_jitter_fraction=0.1)
    rng = np.random.default_rng((seed, 10))
    warped, K1, kp1 = geometric_scale_jitter(img, K, rng, geo, kp)
    warped, K2, kp2 = geometric_crop_jitter(warped, K1, rng, geo, kp1)
    # the two warps' matrices, from the intrinsics they updated: a zoom by s
    # about the centre, then a shift by the principal point's move
    sc, (cx, cy) = K1[0, 0] / K[0, 0], ((W - 1) / 2.0, (H - 1) / 2.0)
    shift = K2[:2, 2] - K1[:2, 2]
    matrices = np.array([[[sc, 0, (1 - sc) * cx], [0, sc, (1 - sc) * cy]],
                         [[1, 0, shift[0]], [0, 1, shift[1]]]])
    out.update(warped=warped, warped_K=K2, warped_keypoints=kp2, warp_matrices=matrices)
    img_u8 = np.round(img * 255).astype(np.uint8)
    und, kp_u = undistort_view(img_u8, kp, K, DIST)
    cam = CameraCalibration("cam_0", (W, H), K, DIST, np.zeros(3), np.zeros(3))
    out.update(undistorted=und, undistorted_keypoints=kp_u,
               calibration_undistorted_points=cam.undistort_points(kp))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="The port's OpenCV paths on seeded inputs")
    ap.add_argument("--out", required=True, help="npz to write")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import cv2

    np.savez_compressed(args.out, opencv_version=np.asarray(cv2.__version__), **run(args.seed))
    print(f"wrote {args.out} (OpenCV {cv2.__version__})")


if __name__ == "__main__":
    main()
