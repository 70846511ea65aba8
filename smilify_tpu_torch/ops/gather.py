"""Row gathers whose backward adds in an order fixed by the indices alone.

On the card the backward of ``torch.gather`` (and ``take_along_dim``) adds
into the source rows with atomics, whose order changes from run to run: the
same registration step gives gradients that differ by rounding, and Adam
turns a gradient that is only rounding into a step of ±lr, so two runs of one
registration part. The two gathers here compute the same forward values (a
gather copies) and sum their backward in a fixed order, with no atomics:

* :func:`gather_rows` — an index shared by every batch row. Given a
  :class:`RowIndex` (an index fixed for many calls: a mesh's edges,
  neighbour table, face adjacency or faces) its backward is a gather of the
  upstream gradient through the inverse table built once on the host
  (:func:`inverse_table`) and a sum along that table's fixed axis: no sort.
  Given a plain index tensor it takes :func:`take_rows`' backward.
* :func:`take_rows` — indices that change every call (the sampled faces,
  the KNN neighbours): its backward sorts the indices (stable, so equal
  indices keep their positions' order) and sums each row's segment in that
  order (``torch.segment_reduce``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable


def inverse_table(index: np.ndarray, n_rows: int, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_rows, D) int64: for each row, the flat positions of ``index`` that
    read it, ascending, padded with ``index.size`` (the position of a zero
    row appended to the upstream gradient). ``valid`` (``index``'s shape,
    bool) leaves out positions whose gradient is zero by construction, such
    as a neighbour table's padding."""
    index = np.asarray(index, np.int64)
    rows, pos = index.reshape(-1), np.arange(index.size)
    if valid is not None:
        keep = np.asarray(valid, bool).reshape(-1)
        rows, pos = rows[keep], pos[keep]
    order = np.argsort(rows, kind="stable")
    rows, pos = rows[order], pos[order]
    counts = np.bincount(rows, minlength=n_rows)
    table = np.full((n_rows, max(1, int(counts.max(initial=0)))), index.size, np.int64)
    table[rows, np.arange(rows.size) - (np.cumsum(counts) - counts)[rows]] = pos
    return table


class RowIndex(NamedTuple):
    """An index into a tensor's rows, fixed for many calls, with its inverse
    (:func:`inverse_table`), both on the device."""

    index: torch.Tensor     # any shape, int64
    inverse: torch.Tensor   # (rows, D) int64

    @classmethod
    def build(cls, index: np.ndarray, n_rows: int, valid: Optional[np.ndarray] = None,
              device="cpu") -> "RowIndex":
        index = np.asarray(index, np.int64)
        return cls(torch.from_numpy(index).to(device),
                   torch.from_numpy(inverse_table(index, n_rows, valid)).to(device))

    @property
    def shape(self) -> torch.Size:
        return self.index.shape


class _GatherFixed(torch.autograd.Function):
    """x (L, R, C) at the rows ``index`` (N,) → (L, N, C); backward through
    the inverse table (R, D)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, index)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        L, _, C = g.shape
        padded = torch.cat([g, g.new_zeros(L, 1, C)], dim=1)
        R, D = inverse.shape
        return padded.index_select(1, inverse.reshape(-1)).view(L, R, D, C).sum(2), None, None


class _TakeRows(torch.autograd.Function):
    """x (L, R, C) at the rows ``idx`` (L, S) of each batch row → (L, S, C);
    backward: a stable sort of the indices, then each row's segment summed
    in that order."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[1]
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        L, S, C = g.shape
        n = L * ctx.rows
        key = (idx + torch.arange(L, device=idx.device)[:, None] * ctx.rows).reshape(-1)
        key, order = torch.sort(key, stable=True)
        lengths = torch.diff(torch.searchsorted(key, torch.arange(n + 1, device=key.device)))
        summed = torch.segment_reduce(g.reshape(L * S, C)[order], "sum", lengths=lengths,
                                      axis=0, unsafe=True)
        return summed.view(L, ctx.rows, C), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., R, C) at rows ``idx`` (..., S) (the same leading dims) →
    (..., S, C): ``torch.take_along_dim(x, idx[..., None], -2)``, with a
    backward in a fixed order."""
    lead, (R, C) = x.shape[:-2], x.shape[-2:]
    out = _TakeRows.apply(x.reshape(-1, R, C), idx.long().reshape(-1, idx.shape[-1]))
    return out.view(*lead, idx.shape[-1], C)


def gather_rows(x: torch.Tensor, index) -> torch.Tensor:
    """x (..., R, C) at the rows ``index`` (a :class:`RowIndex` or an int
    tensor of any shape, shared by the leading dims) → (..., *index.shape,
    C): ``x[..., index, :]``, with a backward in a fixed order."""
    lead, (R, C) = x.shape[:-2], x.shape[-2:]
    if isinstance(index, RowIndex):
        out = _GatherFixed.apply(x.reshape(-1, R, C), index.index.reshape(-1), index.inverse)
        return out.view(*lead, *index.shape, C)
    flat = index.long().reshape(-1)
    return take_rows(x, flat.expand(*lead, flat.numel())).view(*lead, *index.shape, C)
