"""On-the-fly training augmentation (host-side numpy/cv2; port of
``smilify_tpu/data/augmentation.py``: the blur and the warps import OpenCV
when called, so they run only where it is installed).

Equivalent of the reference's dataset augmentations
(``sleap_data/sleap_multiview_dataset.py:801-960``):
  * photometric — brightness / contrast / saturation jitter, gaussian noise,
    gaussian blur, random erasing — keypoints and cameras untouched;
  * geometric — center scale jitter that UPDATES the camera intrinsics K so
    reprojection stays consistent (the invariant the reference's
    test_augmentation.py asserts).

All randomness flows through an explicit ``np.random.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class AugmentationParams:
    enabled: bool = True
    geometric_enabled: bool = False
    color_jitter_brightness: float = 0.2
    color_jitter_contrast: float = 0.2
    color_jitter_saturation: float = 0.15
    gaussian_noise_std: float = 0.015
    gaussian_blur_prob: float = 0.3
    gaussian_blur_kernel_range: Tuple[int, int] = (3, 7)
    random_erasing_prob: float = 0.2
    random_erasing_scale_range: Tuple[float, float] = (0.02, 0.1)
    scale_jitter_range: Tuple[float, float] = (0.9, 1.1)
    crop_jitter_fraction: float = 0.0


def photometric_augment(img: np.ndarray, rng: np.random.Generator, p: AugmentationParams) -> np.ndarray:
    """(H, W, 3) float [0,1] → augmented copy; geometry unchanged."""
    import cv2

    out = img.astype(np.float32).copy()

    b = rng.uniform(-p.color_jitter_brightness, p.color_jitter_brightness)
    out = out + b

    c = 1.0 + rng.uniform(-p.color_jitter_contrast, p.color_jitter_contrast)
    out = (out - out.mean()) * c + out.mean()

    s = 1.0 + rng.uniform(-p.color_jitter_saturation, p.color_jitter_saturation)
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * s

    if p.gaussian_noise_std > 0:
        out = out + rng.normal(0.0, p.gaussian_noise_std, out.shape).astype(np.float32)

    if rng.random() < p.gaussian_blur_prob:
        klo, khi = p.gaussian_blur_kernel_range
        k = int(rng.integers(klo // 2, khi // 2 + 1)) * 2 + 1
        out = cv2.GaussianBlur(out, (k, k), 0)

    if rng.random() < p.random_erasing_prob:
        H, W = out.shape[:2]
        area = H * W * rng.uniform(*p.random_erasing_scale_range)
        aspect = rng.uniform(0.5, 2.0)
        eh = int(np.sqrt(area * aspect))
        ew = int(np.sqrt(area / aspect))
        if eh < H and ew < W and eh > 0 and ew > 0:
            y0 = int(rng.integers(0, H - eh))
            x0 = int(rng.integers(0, W - ew))
            out[y0 : y0 + eh, x0 : x0 + ew] = rng.random(3).astype(np.float32)

    return np.clip(out, 0.0, 1.0)


def geometric_scale_jitter(
    img: np.ndarray,
    K: np.ndarray,
    rng: np.random.Generator,
    p: AugmentationParams,
    keypoints_xy: Optional[np.ndarray] = None,
):
    """Scale about the image center and update K (and pixel keypoints).

    A zoom by factor s about the center is equivalent to multiplying the focal
    lengths by s (principal point at center fixed-point) — so 3D reprojection
    through the updated K lands on the transformed pixels.
    """
    import cv2

    H, W = img.shape[:2]
    s = rng.uniform(*p.scale_jitter_range)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0

    M = np.array([[s, 0, (1 - s) * cx], [0, s, (1 - s) * cy]], dtype=np.float64)
    out = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)

    K_new = K.astype(np.float64).copy()
    K_new[0, 0] *= s
    K_new[1, 1] *= s
    K_new[0, 2] = s * K[0, 2] + (1 - s) * cx
    K_new[1, 2] = s * K[1, 2] + (1 - s) * cy

    kp_new = None
    if keypoints_xy is not None:
        kp = np.asarray(keypoints_xy, dtype=np.float64)
        kp_new = kp * s + np.array([(1 - s) * cx, (1 - s) * cy])
    return out, K_new, kp_new


def geometric_crop_jitter(
    img: np.ndarray,
    K: np.ndarray,
    rng: np.random.Generator,
    p: AugmentationParams,
    keypoints_xy: Optional[np.ndarray] = None,
):
    """Shift the crop window by up to ``crop_jitter_fraction`` of the image
    size and update K (and pixel keypoints).

    Translating image content by (dx, dy) is exactly a principal-point shift
    by (dx, dy), so reprojection through the updated K stays consistent —
    the same invariant the scale jitter keeps.
    """
    import cv2

    H, W = img.shape[:2]
    dx = rng.uniform(-p.crop_jitter_fraction, p.crop_jitter_fraction) * W
    dy = rng.uniform(-p.crop_jitter_fraction, p.crop_jitter_fraction) * H

    M = np.array([[1, 0, dx], [0, 1, dy]], dtype=np.float64)
    out = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)

    K_new = K.astype(np.float64).copy()
    K_new[0, 2] += dx
    K_new[1, 2] += dy

    kp_new = None
    if keypoints_xy is not None:
        kp_new = np.asarray(keypoints_xy, dtype=np.float64) + np.array([dx, dy])
    return out, K_new, kp_new


def augment_multiview_sample(sample: dict, rng: np.random.Generator, p: AugmentationParams) -> dict:
    """Apply photometric (per view) and optional geometric augs to a padded
    multi-view sample dict (see MultiViewHDF5Dataset.__getitem__)."""
    if not p.enabled:
        return sample
    out = dict(sample)
    images = sample["images"].copy()
    K = sample["camera_intrinsics"].copy()
    kp = sample["keypoints_2d"].copy()
    for v in np.nonzero(sample["view_mask"])[0]:
        images[v] = photometric_augment(images[v], rng, p)
        if p.geometric_enabled:
            img, K_new, kp_new = geometric_scale_jitter(images[v], K[v], rng, p, kp[v])
            if p.crop_jitter_fraction > 0:
                img, K_new, kp_new = geometric_crop_jitter(img, K_new, rng, p, kp_new)
            images[v] = img
            K[v] = K_new
            kp[v] = kp_new
    out["images"] = images
    out["camera_intrinsics"] = K
    out["keypoints_2d"] = kp
    return out


def augment_singleview_sample(sample: dict, rng: np.random.Generator, p: AugmentationParams) -> dict:
    """Photometric augmentation of a single-view sample (geometric scale
    jitter needs intrinsics to update; single-view samples carry renderer
    camera params instead, so only photometric applies — matching the
    reference's single-view training path)."""
    if not p.enabled:
        return sample
    out = dict(sample)
    out["image"] = photometric_augment(np.asarray(sample["image"]), rng, p)
    return out


def params_from_config(aug_cfg) -> AugmentationParams:
    """AugmentationConfig (train/config.py) → AugmentationParams."""
    return AugmentationParams(
        enabled=aug_cfg.enabled,
        geometric_enabled=aug_cfg.geometric_enabled,
        color_jitter_brightness=aug_cfg.color_jitter_brightness,
        color_jitter_contrast=aug_cfg.color_jitter_contrast,
        color_jitter_saturation=aug_cfg.color_jitter_saturation,
        gaussian_noise_std=aug_cfg.gaussian_noise_std,
        gaussian_blur_prob=aug_cfg.gaussian_blur_prob,
        gaussian_blur_kernel_range=tuple(aug_cfg.gaussian_blur_kernel_range),
        random_erasing_prob=aug_cfg.random_erasing_prob,
        random_erasing_scale_range=tuple(aug_cfg.random_erasing_scale_range),
        scale_jitter_range=tuple(aug_cfg.scale_jitter_range),
        crop_jitter_fraction=aug_cfg.crop_jitter_fraction,
    )


class AugmentedDataset:
    """Train-split wrapper applying on-the-fly augmentation (the reference
    augments inside SLEAPMultiViewDataset when ``augment=True``,
    sleap_multiview_dataset.py:801-923; validation/test stay clean).

    Per-call RNG is derived from (seed, epoch, index) so augmentation is
    deterministic per epoch, fresh across epochs, and safe under the
    threaded prefetch loader. Call :meth:`set_epoch` each epoch."""

    def __init__(self, dataset, params: AugmentationParams, seed: int = 0,
                 multiview: bool = True):
        self.dataset = dataset
        self.params = params
        self.seed = seed
        self.multiview = multiview
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        # Guard against recursion during unpickling (process-pool workers):
        # pickle probes dunders before __dict__ is restored.
        try:
            dataset = object.__getattribute__(self, "__dict__")["dataset"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(dataset, name)

    def __getitem__(self, idx: int):
        sample = self.dataset[idx]
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        if self.multiview and "images" in sample:
            return augment_multiview_sample(sample, rng, self.params)
        if "image" in sample:
            return augment_singleview_sample(sample, rng, self.params)
        return sample
