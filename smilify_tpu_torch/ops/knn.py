"""K-nearest-neighbor search between point clouds (port of
``smilify_tpu/ops/knn.py``).

The pairwise squared-distance matrix ‖x−y‖² = ‖x‖² + ‖y‖² − 2⟨x, y⟩ is one
matmul, evaluated in one shot for small problems or in query tiles so memory
stays O(tile × M). Exact (not approximate). The matmuls run in full FP32:
PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` False), as the
JAX version pins ``Precision.HIGHEST``.

Gradients use the envelope theorem: neighbor *selection* happens under
``torch.no_grad()`` (``argmin`` for K=1, ``topk`` otherwise), then the
returned distances are recomputed differentiably from the gathered neighbor
points. The value is identical and — because the argmin is locally constant
— so is the gradient, at O(N·K·D) backward cost instead of O(N·M).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# one-shot distance-matrix budget (elements) per cloud pair; ~64 MB f32
_ONESHOT_ELEMS = 16 * 1024 * 1024


class KNNResult(NamedTuple):
    dists: torch.Tensor  # (..., N, K) squared distances, ascending
    idx: torch.Tensor    # (..., N, K) int64 neighbor indices into y
    knn: torch.Tensor    # (..., N, K, D) gathered neighbor points


def _neighbor_indices(x, y_t, y_sq, K):
    """Top-K neighbor indices of each x row in y: x (..., n, D), y_t (..., D, M),
    y_sq (..., M) → (..., n, K). Selection only (no gradient)."""
    d = torch.sum(x * x, dim=-1, keepdim=True) + y_sq[..., None, :] - 2.0 * torch.matmul(x, y_t)
    if K == 1:
        return torch.argmin(d, dim=-1, keepdim=True)
    return torch.topk(-d, K, dim=-1).indices


def gather_neighbors(y, idx):
    """y (..., M, D), idx (..., N, K) → (..., N, K, D)."""
    flat = idx.reshape(*idx.shape[:-2], -1)
    out = torch.gather(y, -2, flat[..., None].expand(*flat.shape, y.shape[-1]))
    return out.reshape(*idx.shape, y.shape[-1])


def knn_points(
    x: torch.Tensor,
    y: torch.Tensor,
    K: int = 1,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    tile: int = 1024,
    oneshot_elems: int = _ONESHOT_ELEMS,
) -> KNNResult:
    """K nearest neighbors in ``y`` for each point of ``x``.

    Args:
      x: (N, D) query points, or (B, N, D).
      y: (M, D) reference points, or (B, M, D).
      K: number of neighbors.
      x_mask / y_mask: optional validity masks ((N,) / (M,), or (B, N) /
        (B, M)); invalid y points are pushed to +inf distance, invalid x rows
        return zeros.
      tile: query rows per distance-matrix tile (when N·M > ``oneshot_elems``).

    Returns :class:`KNNResult` (squared distances, ascending; differentiable
    wrt x and y through the gathered neighbors — envelope gradient).
    """
    N, M = x.shape[-2], y.shape[-2]
    with torch.no_grad():
        y_sq = torch.sum(y * y, dim=-1)
        if y_mask is not None:
            y_sq = torch.where(y_mask, y_sq, torch.full_like(y_sq, float("inf")))
        y_t = y.transpose(-1, -2)
        if N * M <= oneshot_elems:
            idx = _neighbor_indices(x, y_t, y_sq, K)
        else:
            idx = torch.cat([_neighbor_indices(x[..., s:s + tile, :], y_t, y_sq, K)
                             for s in range(0, N, tile)], dim=-2)

    knn = gather_neighbors(y, idx)              # differentiable gather
    diff = x[..., :, None, :] - knn
    dists = torch.sum(diff * diff, dim=-1)      # (..., N, K)
    if y_mask is not None:
        y_ok = gather_neighbors(y_mask[..., None], idx)[..., 0]
        dists = torch.where(y_ok, dists, torch.full_like(dists, float("inf")))
    if x_mask is not None:
        dists = torch.where(x_mask[..., None], dists, torch.zeros_like(dists))
        idx = torch.where(x_mask[..., None], idx, torch.zeros_like(idx))
    return KNNResult(dists=dists, idx=idx, knn=knn)
