"""Silhouette metrics (port of the metric part of ``smilify_tpu/utils/visualization.py``)."""

from __future__ import annotations

import numpy as np
import torch


def silhouette_iou(a, b, threshold: float = 0.5) -> float:
    """IoU between two silhouettes (soft maps thresholded at ``threshold``;
    tensors on any device or arrays); 1.0 when both are empty."""
    A = _host(a) > threshold
    B = _host(b) > threshold
    inter = np.logical_and(A, B).sum()
    union = np.logical_or(A, B).sum()
    return float(inter) / float(union) if union else 1.0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
