"""Work-list soft-silhouette kernels — the capped raster mode (port of
``smilify_tpu/render/rasterizer_worklist.py``).

Instead of walking every face chunk, each 32×32 tile gets a **work list**:
the 8-face subgroups whose bounding box (+ blur margin) touches the tile,
sorted nearest-z first and capped at ``k_sub`` entries. This is the
reference-faithful approximation: PyTorch3D's rasterizer keeps only the
100 z-nearest faces per pixel, so a z-sorted per-tile cap drops the same
far-face tails. With a cap that never truncates, the result matches the
exact raster (same subgroups, same math).

The lists are built in plain PyTorch (``torch.topk`` on the same keys as the
JAX package's ``lax.top_k``). Two kernels walk them — ``worklist_fwd`` and
``worklist_bwd``, each beside its plain version — with the same dispatch
and launch counters as :mod:`rasterizer`. The forward walks the list in
batches of 64 subgroups and stops a tile once every pixel has S ≥ 20 at the
start of a batch.
"""

from __future__ import annotations

import torch

from smilify_tpu_torch.render import _kernels
from smilify_tpu_torch.render.rasterizer import (
    FACE_GROUP,
    GRAD_SKIP,
    GROUPS_PER_CHUNK,
    GROUPS_PER_WORD,
    SATURATION_S,
    TILE_PIX,
    _bwd_terms,
    _face_rows,
    _fwd_terms,
    _group_overlap,
    _image_to_tiles,
    _tile_grid,
    _tile_pixels,
    _tiles_to_image,
)


def _pack_faces_flat(tri_xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, F, 3, 2) + (N, F) → (N, F8, 8) with F8 = F rounded up to FACE_GROUP."""
    return _face_rows(tri_xy, valid, FACE_GROUP)


def _tile_worklists(tri_xy, tri_z, valid, H, W, sigma, k_sub: int):
    """Per-tile subgroup work lists, nearest-z first.

    Returns (idx, count): idx (N, T, k_sub) int32 subgroup ids (arbitrary
    past count), count (N, T) int32 number of valid entries (overlaps clipped
    to k_sub)."""
    N, F = tri_xy.shape[0], tri_xy.shape[1]
    pad = (-F) % FACE_GROUP
    overlap = _group_overlap(tri_xy, valid, H, W, sigma, pad)          # (N, T, G)
    zmin = torch.where(valid, tri_z.amin(dim=-1), 1e9)
    gz = torch.nn.functional.pad(zmin, (0, pad), value=1e9).reshape(N, -1, FACE_GROUP).amin(-1)

    # nearest-z-first ordering: top-k over −z with non-overlapping groups at
    # −inf keys; finite keys sort to the front, so `count` bounds the walk
    key = torch.where(overlap, -gz[:, None, :], -torch.inf)
    k = min(k_sub, overlap.shape[-1])
    idx = torch.topk(key, k, dim=-1).indices                           # (N, T, k)
    if k < k_sub:
        idx = torch.nn.functional.pad(idx, (0, k_sub - k))
    count = torch.clamp_max(overlap.sum(dim=-1), k)
    return idx.to(torch.int32).contiguous(), count.to(torch.int32).contiguous()


def _gather_entries(face_flat, idx, count, n_i, t_i, s0, s1):
    """Face rows (P, m·8, 8) of list entries s0..s1 of tiles (n_i, t_i), and
    a (P, m·8) gate that is False for entries past each tile's count."""
    ids = idx[n_i, t_i, s0:s1].long()                                  # (P, m)
    entries = torch.arange(s0, s1, device=idx.device)
    gate = entries[None] < count[n_i, t_i, None].long()
    rows = (ids[..., None] * FACE_GROUP
            + torch.arange(FACE_GROUP, device=idx.device)).reshape(ids.shape[0], -1)
    return face_flat[n_i[:, None], rows], gate.repeat_interleave(FACE_GROUP, dim=-1), rows


# ---------------------------------------------------------------------------
# K3: work-list forward — kernel wrapper and plain version
# ---------------------------------------------------------------------------


def worklist_fwd_plain(face_flat, idx, count, H, W, sigma):
    """Plain version of the work-list forward kernel: S tiles (N, T,
    TILE_PIX). Each tile walks its first ``count`` entries in batches of
    GROUPS_PER_CHUNK, and stops once its minimum S reached SATURATION_S at
    the start of a batch."""
    N, T, k_sub = idx.shape
    px, py = _tile_pixels(H, W, face_flat.dtype, face_flat.device)
    S = torch.zeros((N, T, TILE_PIX), dtype=face_flat.dtype, device=face_flat.device)
    inv_sigma = 1.0 / sigma
    for b0 in range(0, k_sub, GROUPS_PER_CHUNK):
        live = (count > b0) & (S.amin(dim=-1) < SATURATION_S)
        for s0 in range(b0, min(b0 + GROUPS_PER_CHUNK, k_sub), GROUPS_PER_WORD):
            s1 = min(s0 + GROUPS_PER_WORD, k_sub)
            n_i, t_i = torch.nonzero(live & (count > s0), as_tuple=True)
            if n_i.numel() == 0:
                continue
            fa, gate, _ = _gather_entries(face_flat, idx, count, n_i, t_i, s0, s1)
            S.index_put_((n_i, t_i), _fwd_terms(px[t_i], py[t_i], fa, gate, inv_sigma),
                         accumulate=True)
    return S


def worklist_fwd(face_flat, idx, count, H, W, sigma, work=None):
    """S tiles (N, T, TILE_PIX) of the work-list raster: the CUDA kernel
    ``worklist_fwd_kernel`` (csrc/raster.cu) for CUDA tensors, the plain
    version for CPU tensors. ``work`` as for ``rasterizer.exact_fwd``."""
    if face_flat.device.type == "cpu":
        return worklist_fwd_plain(face_flat, idx, count, H, W, sigma)
    N, F8 = face_flat.shape[0], face_flat.shape[1]
    _, _, T = _tile_grid(H, W)
    k_sub = idx.shape[-1]
    _kernels.check(face_flat, "face_flat", torch.float32, (N, F8, 8))
    _kernels.check(idx, "idx", torch.int32, (N, T, k_sub), face_flat.device)
    _kernels.check(count, "count", torch.int32, (N, T), face_flat.device)
    _kernels.check_work(work, N * T, face_flat.device)
    S = torch.empty((N, T, TILE_PIX), dtype=torch.float32, device=face_flat.device)
    with torch.cuda.device(face_flat.device):
        _kernels.launch(
            "smil_worklist_fwd", face_flat.data_ptr(), idx.data_ptr(), count.data_ptr(),
            S.data_ptr(), _kernels.ptr(work), N, F8, k_sub, H, W, 1.0 / sigma,
            _kernels.stream())
    worklist_fwd.launches += 1
    worklist_fwd.frames += N
    return S


worklist_fwd.launches = 0
worklist_fwd.frames = 0


# ---------------------------------------------------------------------------
# K4: work-list backward — kernel wrapper and plain version
# ---------------------------------------------------------------------------


def worklist_bwd_plain(face_flat, idx, count, gS_tiles, H, W, sigma):
    """Plain version of the work-list backward kernel: dS/d(face rows)
    (N, F8, 8) (columns 0-5 set), summed over every listed (tile, subgroup)
    pair of the tiles whose |gS| exceeds GRAD_SKIP somewhere."""
    N, T, k_sub = idx.shape
    F8 = face_flat.shape[1]
    px, py = _tile_pixels(H, W, face_flat.dtype, face_flat.device)
    on = gS_tiles.abs().amax(dim=-1) > GRAD_SKIP
    dflat = torch.zeros((N * F8, 6), dtype=face_flat.dtype, device=face_flat.device)
    inv_sigma = 1.0 / sigma
    for s0 in range(0, k_sub, GROUPS_PER_WORD):
        s1 = min(s0 + GROUPS_PER_WORD, k_sub)
        n_i, t_i = torch.nonzero(on & (count > s0), as_tuple=True)
        if n_i.numel() == 0:
            continue
        fa, gate, rows = _gather_entries(face_flat, idx, count, n_i, t_i, s0, s1)
        g6 = _bwd_terms(px[t_i], py[t_i], fa, gate, gS_tiles[n_i, t_i], inv_sigma)
        dflat.index_add_(0, (n_i[:, None] * F8 + rows).reshape(-1), g6.reshape(-1, 6))
    dface = torch.zeros_like(face_flat)
    dface[..., :6] = dflat.reshape(N, F8, 6)
    return dface


def worklist_bwd(face_flat, idx, count, gS_tiles, H, W, sigma, work=None):
    """dS/d(face rows) of the work-list raster: the CUDA kernel
    ``worklist_bwd_kernel`` for CUDA tensors, the plain version for CPU ones.
    ``work`` as for ``rasterizer.exact_bwd``: zeroed by the caller."""
    if face_flat.device.type == "cpu":
        return worklist_bwd_plain(face_flat, idx, count, gS_tiles, H, W, sigma)
    N, F8 = face_flat.shape[0], face_flat.shape[1]
    _, _, T = _tile_grid(H, W)
    k_sub = idx.shape[-1]
    _kernels.check(face_flat, "face_flat", torch.float32, (N, F8, 8))
    _kernels.check(idx, "idx", torch.int32, (N, T, k_sub), face_flat.device)
    _kernels.check(count, "count", torch.int32, (N, T), face_flat.device)
    _kernels.check(gS_tiles, "gS_tiles", torch.float32, (N, T, TILE_PIX), face_flat.device)
    _kernels.check_work(work, N * T, face_flat.device)
    dface = torch.zeros_like(face_flat)
    with torch.cuda.device(face_flat.device):
        _kernels.launch(
            "smil_worklist_bwd", face_flat.data_ptr(), idx.data_ptr(), count.data_ptr(),
            gS_tiles.data_ptr(), dface.data_ptr(), _kernels.ptr(work), N, F8, k_sub, H, W,
            1.0 / sigma, _kernels.stream())
    worklist_bwd.launches += 1
    worklist_bwd.frames += N
    return dface


worklist_bwd.launches = 0
worklist_bwd.frames = 0


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _RasterSWorklist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tri_xy, tri_z, valid, image_size, sigma, k_sub):
        H, W = image_size
        face_flat = _pack_faces_flat(tri_xy, valid)
        idx, count = _tile_worklists(tri_xy, tri_z, valid, H, W, sigma, k_sub)
        S_tiles = worklist_fwd(face_flat, idx, count, H, W, sigma)
        ctx.save_for_backward(face_flat, idx, count)
        ctx.meta = (tri_xy.shape[1], H, W, sigma)
        return _tiles_to_image(S_tiles, H, W)

    @staticmethod
    def backward(ctx, gS):
        face_flat, idx, count = ctx.saved_tensors
        F, H, W, sigma = ctx.meta
        dface = worklist_bwd(face_flat, idx, count, _image_to_tiles(gS, H, W), H, W, sigma)
        N = dface.shape[0]
        return dface[:, :F, :6].reshape(N, F, 3, 2), None, None, None, None, None


def raster_S_worklist(tri_xy, tri_z, valid, image_size, sigma, k_sub):
    """Capped S (N, H, W): each tile rasterizes at most ``k_sub`` z-nearest
    8-face subgroups; differentiable wrt tri_xy (kernel K3 forward, K4
    backward)."""
    return _RasterSWorklist.apply(tri_xy, tri_z, valid, tuple(image_size), float(sigma), int(k_sub))
