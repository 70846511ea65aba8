"""Soft-silhouette rasterizer with hand-written CUDA kernels (port of
``smilify_tpu/render/rasterizer.py``).

Same aggregation semantics as :mod:`rasterizer_ref` (the exact log-space
SoftRas sum over all faces):

    S(p)  = Σ_f valid_f · softplus(−d_f(p) / σ),   alpha = 1 − exp(−S)

The image is cut into 32×32 pixel tiles (T of them) and the faces into chunks
of 512 (C of them), each packed as 32-byte rows (ax, ay, bx, by, cx, cy,
valid, pad). A coarse cull mask, built here in plain PyTorch, holds one
16-bit word per (frame, tile, 128 faces): bit g is set when the bounding box
(+ blur margin √(14σ)) of 8-face subgroup g touches the tile. The kernels skip
chunks whose words are all 0 and subgroups whose bit is 0, and the forward
kernel stops a tile once every pixel has S ≥ 20 (alpha within 2e-9 of 1).

Two kernels do the work, each with a plain-PyTorch version of the same
function beside it (``exact_fwd`` / ``exact_fwd_plain``, ``exact_bwd`` /
``exact_bwd_plain``). A wrapper launches its CUDA kernel for a CUDA tensor
(a build or launch failure raises) and runs the plain version for a CPU
tensor; each counts its launches in ``<wrapper>.launches`` and the frames
those launches took in ``<wrapper>.frames``.

The TPU-only plumbing of the JAX package has no counterpart here: its SMEM
budget for the scalar-prefetched cull mask and the frame sub-batching it
forced (``SMEM_MASK_BUDGET_BYTES``); the kernels read the mask from device
memory, so every frame goes in one launch.
"""

from __future__ import annotations

import math

import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.render import _kernels
from smilify_tpu_torch.render.rasterizer_ref import SIGMA, soft_silhouette_ref, softplus

TILE_H = 32
TILE_W = 32
TILE_PIX = TILE_H * TILE_W        # 1024 pixels per tile
FACE_CHUNK = 512                  # faces per chunk
WORD = 128                        # faces covered by one 16-bit cull word
FACE_GROUP = 8                    # faces per cull subgroup
N_WORDS = FACE_CHUNK // WORD
GROUPS_PER_WORD = WORD // FACE_GROUP
GROUPS_PER_CHUNK = FACE_CHUNK // FACE_GROUP
# softplus(-d/σ) < 8.3e-7 once d > 14σ — faces farther than this contribute
# less than ~2e-5 alpha even with dozens of them at the cutoff
CULL_MARGIN_SQ_SIGMAS = 14.0
# once EVERY pixel of a tile has S > 20 (alpha within e⁻²⁰≈2e-9 of 1), later
# faces cannot change the tile
SATURATION_S = 20.0
# the backward skips a tile whose incoming dS is at most this everywhere
# (dS carries the e^{−S} factor of alpha = 1 − e^{−S}: saturated or
# loss-untouched tiles are exactly 0)
GRAD_SKIP = 1e-12


def _cdiv(a, b):
    return -(-a // b)


def _tile_grid(H, W):
    n_ty, n_tx = _cdiv(H, TILE_H), _cdiv(W, TILE_W)
    return n_ty, n_tx, n_ty * n_tx


# ---------------------------------------------------------------------------
# tiles, packing and cull mask (plain PyTorch, shared by both raster modes)
# ---------------------------------------------------------------------------


def _tile_pixels(H, W, dtype, device):
    """NDC (x, y) of every pixel of every tile, each (T, TILE_PIX); pixel q
    of tile t is row t // n_tx · 32 + q // 32, col t % n_tx · 32 + q % 32."""
    _, n_tx, T = _tile_grid(H, W)
    s = float(min(H, W))
    q = torch.arange(TILE_PIX, device=device)
    t = torch.arange(T, device=device)[:, None]
    rows = (t // n_tx) * TILE_H + q // TILE_W
    cols = (t % n_tx) * TILE_W + q % TILE_W
    y = -(rows.to(dtype) * 2.0 + 1.0 - H) / s
    x = -(cols.to(dtype) * 2.0 + 1.0 - W) / s
    return x, y


def _tile_bounds(H, W, dtype, device):
    """NDC extent of each tile row (ymin, ymax over n_ty) and tile column
    (xmin, xmax over n_tx); NDC y falls with the pixel row, x with the col."""
    n_ty, n_tx, _ = _tile_grid(H, W)
    s = float(min(H, W))
    i = torch.arange(n_ty, dtype=dtype, device=device)
    j = torch.arange(n_tx, dtype=dtype, device=device)
    tile_ymax = -(i * TILE_H * 2.0 + 1.0 - H) / s
    tile_ymin = -(((i + 1) * TILE_H - 1) * 2.0 + 1.0 - H) / s
    tile_xmax = -(j * TILE_W * 2.0 + 1.0 - W) / s
    tile_xmin = -(((j + 1) * TILE_W - 1) * 2.0 + 1.0 - W) / s
    return tile_ymin, tile_ymax, tile_xmin, tile_xmax


def _group_overlap(tri_xy, valid, H, W, sigma, pad):
    """(N, T, G) bool: 8-face subgroup g (faces padded by ``pad``) overlaps
    tile t, its bounding box grown by the blur margin; padding and invalid
    faces never overlap."""
    N = tri_xy.shape[0]
    big = 1e9
    x = tri_xy[..., 0]
    y = tri_xy[..., 1]

    def group(v, fill, reduce):
        v = torch.nn.functional.pad(v, (0, pad), value=fill)
        return reduce(v.reshape(N, -1, FACE_GROUP), dim=-1)

    def gmin(v):
        return group(torch.where(valid, v.amin(dim=-1), big), big, torch.amin)

    def gmax(v):
        return group(torch.where(valid, v.amax(dim=-1), -big), -big, torch.amax)

    gxmin, gxmax, gymin, gymax = gmin(x), gmax(x), gmin(y), gmax(y)   # (N, G)
    margin = math.sqrt(CULL_MARGIN_SQ_SIGMAS * sigma)
    tile_ymin, tile_ymax, tile_xmin, tile_xmax = _tile_bounds(H, W, tri_xy.dtype, tri_xy.device)
    oy = (gymin[:, None, :] <= tile_ymax[None, :, None] + margin) & (
        gymax[:, None, :] >= tile_ymin[None, :, None] - margin
    )                                                                  # (N, n_ty, G)
    ox = (gxmin[:, None, :] <= tile_xmax[None, :, None] + margin) & (
        gxmax[:, None, :] >= tile_xmin[None, :, None] - margin
    )                                                                  # (N, n_tx, G)
    return (oy[:, :, None, :] & ox[:, None, :, :]).reshape(N, oy.shape[1] * ox.shape[1], -1)


def _face_rows(tri_xy: torch.Tensor, valid: torch.Tensor, multiple: int) -> torch.Tensor:
    """(N, F, 3, 2) triangles + (N, F) validity → (N, F', 8) rows (ax, ay, bx,
    by, cx, cy, valid, 0), zero-padded to F' = F rounded up to ``multiple``."""
    N, F = tri_xy.shape[0], tri_xy.shape[1]
    flat = torch.cat(
        [
            tri_xy.reshape(N, F, 6),
            valid.to(tri_xy.dtype)[..., None],
            torch.zeros((N, F, 1), dtype=tri_xy.dtype, device=tri_xy.device),
        ],
        dim=-1,
    )
    return torch.nn.functional.pad(flat, (0, 0, 0, (-F) % multiple)).contiguous()


def _pack_faces(tri_xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, F, 3, 2) triangles + (N, F) validity → (N, C, FACE_CHUNK, 8) chunks."""
    return _face_rows(tri_xy, valid, FACE_CHUNK).reshape(tri_xy.shape[0], -1, FACE_CHUNK, 8)


def _tile_cull_mask(tri_xy, valid, H, W, sigma) -> torch.Tensor:
    """(N · T · C · N_WORDS,) int32 cull words: bit g of word (f, t, c, w) set
    ⇔ 8-face subgroup g of word w of chunk c touches tile t (+ blur margin) in
    frame f."""
    N, F = tri_xy.shape[0], tri_xy.shape[1]
    hit = _group_overlap(tri_xy, valid, H, W, sigma, (-F) % FACE_CHUNK)
    hit = hit.reshape(N, hit.shape[1], -1, N_WORDS, GROUPS_PER_WORD)   # (N, T, C, W, G)
    shifts = torch.arange(GROUPS_PER_WORD, device=tri_xy.device)
    bits = torch.sum(hit.to(torch.int32) << shifts, dim=-1)
    return bits.reshape(-1).to(torch.int32)


def _mask_bits(mask, N, T, C):
    """Cull words → (N, T, C, GROUPS_PER_CHUNK) bool, subgroup-major."""
    shifts = torch.arange(GROUPS_PER_WORD, device=mask.device)
    bits = (mask.reshape(N, T, C, N_WORDS, 1) >> shifts) & 1
    return bits.reshape(N, T, C, GROUPS_PER_CHUNK).bool()


def _tiles_to_image(S_tiles, H, W):
    """(N, T, TILE_PIX) → (N, H, W)."""
    n_ty, n_tx, _ = _tile_grid(H, W)
    N = S_tiles.shape[0]
    S = S_tiles.reshape(N, n_ty, n_tx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
    return S.reshape(N, n_ty * TILE_H, n_tx * TILE_W)[:, :H, :W]


def _image_to_tiles(gS, H, W):
    """(N, H, W) → (N, T, TILE_PIX), zero-padded to whole tiles."""
    n_ty, n_tx, T = _tile_grid(H, W)
    N = gS.shape[0]
    g = torch.nn.functional.pad(gS, (0, n_tx * TILE_W - W, 0, n_ty * TILE_H - H))
    g = g.reshape(N, n_ty, TILE_H, n_tx, TILE_W).permute(0, 1, 3, 2, 4)
    return g.reshape(N, T, TILE_PIX).contiguous()


# ---------------------------------------------------------------------------
# the per-(face, pixel) math of the plain versions
# ---------------------------------------------------------------------------


def _point_segment_sq_t(px, py, ax, ay, bx, by):
    ex, ey = bx - ax, by - ay
    dx, dy = px - ax, py - ay
    seg_rinv = 1.0 / torch.clamp_min(ex * ex + ey * ey, 1e-12)
    t = torch.clamp((dx * ex + dy * ey) * seg_rinv, 0.0, 1.0)
    rx = dx - t * ex
    ry = dy - t * ey
    cross = ex * dy - ey * dx
    return rx * rx + ry * ry, t, rx, ry, cross


def _signed_distance(px, py, fa):
    """Pixels px, py (P, 1, TILE_PIX) against face rows fa (P, M, 8):
    signed squared distance (P, M, TILE_PIX) plus the per-edge terms the
    backward needs."""
    ax, ay, bx, by, cx, cy = (fa[..., k:k + 1] for k in range(6))
    d1, t1, r1x, r1y, c0 = _point_segment_sq_t(px, py, ax, ay, bx, by)
    d2, t2, r2x, r2y, c1 = _point_segment_sq_t(px, py, bx, by, cx, cy)
    d3, t3, r3x, r3y, c2 = _point_segment_sq_t(px, py, cx, cy, ax, ay)
    dmin = torch.minimum(torch.minimum(d1, d2), d3)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    sign = torch.where(inside, -1.0, 1.0)
    return sign * dmin, (d1, t1, r1x, r1y, d2, t2, r2x, r2y, d3, t3, r3x, r3y, sign)


def _fwd_terms(px, py, fa, gate, inv_sigma):
    """Σ over faces of valid·softplus(−d/σ) for gathered (tile, faces) pairs:
    px, py (P, TILE_PIX), fa (P, M, 8), gate (P, M) bool → (P, TILE_PIX)."""
    d, _ = _signed_distance(px[:, None], py[:, None], fa)
    contrib = fa[..., 6:7] * softplus(-d * inv_sigma)
    return torch.where(gate[..., None], contrib, 0.0).sum(dim=1)


def _bwd_terms(px, py, fa, gate, G, inv_sigma):
    """dS/d(ax, ay, bx, by, cx, cy) summed over each tile's pixels: the
    envelope gradient at the optimal edge parameter t, routed to the argmin
    edge. G (P, TILE_PIX) is the incoming dS → (P, M, 6)."""
    d, aux = _signed_distance(px[:, None], py[:, None], fa)
    (d1, t1, r1x, r1y, d2, t2, r2x, r2y, d3, t3, r3x, r3y, sign) = aux
    # dS/d(d_signed) = −sigmoid(−d/σ)/σ; chain with sign for dmin
    wgt = G[:, None] * fa[..., 6:7] * torch.sigmoid(-d * inv_sigma) * (-inv_sigma) * sign
    wgt = torch.where(gate[..., None], wgt, 0.0)
    e1 = (d1 <= d2) & (d1 <= d3)
    e2 = ~e1 & (d2 <= d3)
    e3 = ~e1 & ~e2
    f1 = torch.where(e1, wgt, 0.0)
    f2 = torch.where(e2, wgt, 0.0)
    f3 = torch.where(e3, wgt, 0.0)
    # point-segment grads at optimal t (envelope): r = p−u−t(v−u)
    # ∂d/∂u = −2(1−t)r ; ∂d/∂v = −2t·r — summed over the tile's pixels
    gax = (f1 * (-2.0) * (1.0 - t1) * r1x + f3 * (-2.0) * t3 * r3x).sum(-1)
    gay = (f1 * (-2.0) * (1.0 - t1) * r1y + f3 * (-2.0) * t3 * r3y).sum(-1)
    gbx = (f1 * (-2.0) * t1 * r1x + f2 * (-2.0) * (1.0 - t2) * r2x).sum(-1)
    gby = (f1 * (-2.0) * t1 * r1y + f2 * (-2.0) * (1.0 - t2) * r2y).sum(-1)
    gcx = (f2 * (-2.0) * t2 * r2x + f3 * (-2.0) * (1.0 - t3) * r3x).sum(-1)
    gcy = (f2 * (-2.0) * t2 * r2y + f3 * (-2.0) * (1.0 - t3) * r3y).sum(-1)
    return torch.stack([gax, gay, gbx, gby, gcx, gcy], dim=-1)


# ---------------------------------------------------------------------------
# K1: exact forward — kernel wrapper and plain version
# ---------------------------------------------------------------------------


def exact_fwd_plain(face_data, mask, H, W, sigma):
    """Plain version of the exact forward kernel: S tiles (N, T, TILE_PIX)
    from packed faces (N, C, FACE_CHUNK, 8) and cull words. Chunks run in
    order; a tile skips a chunk whose words are 0, or all remaining chunks
    once its minimum S reached SATURATION_S at the start of a chunk."""
    N, C = face_data.shape[0], face_data.shape[1]
    _, _, T = _tile_grid(H, W)
    px, py = _tile_pixels(H, W, face_data.dtype, face_data.device)
    bits = _mask_bits(mask, N, T, C)
    S = torch.zeros((N, T, TILE_PIX), dtype=face_data.dtype, device=face_data.device)
    inv_sigma = 1.0 / sigma
    for c in range(C):
        live = bits[:, :, c].any(dim=-1) & (S.amin(dim=-1) < SATURATION_S)
        for w in range(N_WORDS):
            gw = bits[:, :, c, w * GROUPS_PER_WORD:(w + 1) * GROUPS_PER_WORD]
            n_i, t_i = torch.nonzero(live & gw.any(dim=-1), as_tuple=True)
            if n_i.numel() == 0:
                continue
            fa = face_data[n_i, c, w * WORD:(w + 1) * WORD]              # (P, WORD, 8)
            gate = gw[n_i, t_i].repeat_interleave(FACE_GROUP, dim=-1)    # (P, WORD)
            S.index_put_((n_i, t_i), _fwd_terms(px[t_i], py[t_i], fa, gate, inv_sigma),
                         accumulate=True)
    return S


def exact_fwd(face_data, mask, H, W, sigma, work=None):
    """S tiles (N, T, TILE_PIX) of the exact raster: the CUDA kernel
    ``exact_fwd_kernel`` (csrc/raster.cu) for CUDA tensors, the plain version
    for CPU tensors. ``work`` (CUDA only, optional, int32 (N·T,)) receives the
    number of 8-face subgroups each tile evaluated."""
    if face_data.device.type == "cpu":
        return exact_fwd_plain(face_data, mask, H, W, sigma)
    N, C = face_data.shape[0], face_data.shape[1]
    _, _, T = _tile_grid(H, W)
    _kernels.check(face_data, "face_data", torch.float32, (N, C, FACE_CHUNK, 8))
    _kernels.check(mask, "mask", torch.int32, (N * T * C * N_WORDS,), face_data.device)
    _kernels.check_work(work, N * T, face_data.device)
    S = torch.empty((N, T, TILE_PIX), dtype=torch.float32, device=face_data.device)
    with torch.cuda.device(face_data.device):
        _kernels.launch(
            "smil_exact_fwd", face_data.data_ptr(), mask.data_ptr(), S.data_ptr(),
            _kernels.ptr(work), N, C, H, W, 1.0 / sigma, _kernels.stream())
    exact_fwd.launches += 1
    exact_fwd.frames += N
    return S


exact_fwd.launches = 0
exact_fwd.frames = 0


# ---------------------------------------------------------------------------
# K2: exact backward — kernel wrapper and plain version
# ---------------------------------------------------------------------------


def exact_bwd_plain(face_data, mask, gS_tiles, H, W, sigma):
    """Plain version of the exact backward kernel: dS/d(face rows)
    (N, C, FACE_CHUNK, 8) (columns 0-5 set) for incoming gS tiles
    (N, T, TILE_PIX). Every subgroup whose cull bit is set contributes, in
    every tile whose |gS| exceeds GRAD_SKIP somewhere."""
    N, C = face_data.shape[0], face_data.shape[1]
    _, _, T = _tile_grid(H, W)
    px, py = _tile_pixels(H, W, face_data.dtype, face_data.device)
    bits = _mask_bits(mask, N, T, C)
    on = gS_tiles.abs().amax(dim=-1) > GRAD_SKIP
    dface = torch.zeros_like(face_data)
    inv_sigma = 1.0 / sigma
    for c in range(C):
        for w in range(N_WORDS):
            gw = bits[:, :, c, w * GROUPS_PER_WORD:(w + 1) * GROUPS_PER_WORD]
            n_i, t_i = torch.nonzero(on & gw.any(dim=-1), as_tuple=True)
            if n_i.numel() == 0:
                continue
            fa = face_data[n_i, c, w * WORD:(w + 1) * WORD]
            gate = gw[n_i, t_i].repeat_interleave(FACE_GROUP, dim=-1)
            g6 = _bwd_terms(px[t_i], py[t_i], fa, gate, gS_tiles[n_i, t_i], inv_sigma)
            acc = torch.zeros((N, WORD, 6), dtype=g6.dtype, device=g6.device)
            dface[:, c, w * WORD:(w + 1) * WORD, :6] += acc.index_add_(0, n_i, g6)
    return dface


def exact_bwd(face_data, mask, gS_tiles, H, W, sigma, work=None):
    """dS/d(face rows) of the exact raster: the CUDA kernel
    ``exact_bwd_kernel`` for CUDA tensors, the plain version for CPU ones.
    ``work`` (CUDA only, optional, int32 (N·T,)) must come zeroed: the
    kernel's blocks add the 8-face subgroups they evaluate to their tile's
    entry."""
    if face_data.device.type == "cpu":
        return exact_bwd_plain(face_data, mask, gS_tiles, H, W, sigma)
    N, C = face_data.shape[0], face_data.shape[1]
    _, _, T = _tile_grid(H, W)
    _kernels.check(face_data, "face_data", torch.float32, (N, C, FACE_CHUNK, 8))
    _kernels.check(mask, "mask", torch.int32, (N * T * C * N_WORDS,), face_data.device)
    _kernels.check(gS_tiles, "gS_tiles", torch.float32, (N, T, TILE_PIX), face_data.device)
    _kernels.check_work(work, N * T, face_data.device)
    dface = torch.zeros_like(face_data)
    with torch.cuda.device(face_data.device):
        _kernels.launch(
            "smil_exact_bwd", face_data.data_ptr(), mask.data_ptr(), gS_tiles.data_ptr(),
            dface.data_ptr(), _kernels.ptr(work), N, C, H, W, 1.0 / sigma, _kernels.stream())
    exact_bwd.launches += 1
    exact_bwd.frames += N
    return dface


exact_bwd.launches = 0
exact_bwd.frames = 0


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _RasterS(torch.autograd.Function):
    """S (N, H, W) from triangle xy (N, F, 3, 2); gradient to tri_xy only
    (the validity mask is piecewise constant)."""

    @staticmethod
    def forward(ctx, tri_xy, valid, image_size, sigma):
        H, W = image_size
        face_data = _pack_faces(tri_xy, valid)
        mask = _tile_cull_mask(tri_xy, valid, H, W, sigma)
        S_tiles = exact_fwd(face_data, mask, H, W, sigma)
        # packed faces + cull words are small (~200 kB a frame) and save
        # rebuilding both in the backward pass
        ctx.save_for_backward(face_data, mask)
        ctx.meta = (tri_xy.shape[1], H, W, sigma)
        return _tiles_to_image(S_tiles, H, W)

    @staticmethod
    def backward(ctx, gS):
        face_data, mask = ctx.saved_tensors
        F, H, W, sigma = ctx.meta
        dface = exact_bwd(face_data, mask, _image_to_tiles(gS, H, W), H, W, sigma)
        N = dface.shape[0]
        return dface.reshape(N, -1, 8)[:, :F, :6].reshape(N, F, 3, 2), None, None, None


def raster_S(tri_xy, valid, image_size, sigma=SIGMA):
    """Exact S (N, H, W) of triangles tri_xy (N, F, 3, 2) with validity
    (N, F); differentiable wrt tri_xy (kernel K1 forward, K2 backward)."""
    return _RasterS.apply(tri_xy, valid, tuple(image_size), float(sigma))


def auto_approx_max_faces(image_size, device="cuda") -> int | None:
    """The default work-list cap of the fitting CLIs (None = exact).

    800 at 512², scaled with 1/resolution below that (a 32×32 tile covers a
    larger share of a small image, so it meets more faces); None for tiny
    images and off the card, where the cap buys nothing."""
    if resolve_device(device).type != "cuda":
        return None
    size = max(tuple(image_size))
    if size < 128:
        return None  # tiny images: per-tile counts ≈ F, a cap buys nothing
    return max(800, int(800 * 512 / size))


def soft_silhouette(
    verts_ndc: torch.Tensor,
    faces: torch.Tensor,
    image_size,
    sigma: float = SIGMA,
    znear: float = 0.0,
    use_reference: bool = False,
    approx_max_faces: int | None = None,
) -> torch.Tensor:
    """Soft silhouette from NDC vertices; alpha in [0, 1].

    Accepts one frame ``(V, 3)`` → ``(H, W)`` or a frame batch ``(N, V, 3)``
    → ``(N, H, W)``; differentiable wrt the xy of ``verts_ndc``. Runs on the
    device of ``verts_ndc``: the CUDA kernels there, their plain versions on
    the CPU.

    ``use_reference=True`` renders with the all-faces reference raster
    (:func:`rasterizer_ref.soft_silhouette_ref`, autograd) instead.
    ``approx_max_faces`` opts into the work-list raster
    (:mod:`rasterizer_worklist`): per 32×32 tile, only the z-nearest
    ``approx_max_faces`` overlapping faces are rasterized. None = exact.
    """
    if approx_max_faces is not None and use_reference:
        # the cap is implemented BY the work-list kernels; honoring it on the
        # reference path would silently return the exact raster instead
        raise ValueError(
            "approx_max_faces requires the work-list raster; it cannot be "
            "combined with use_reference=True (the all-faces reference raster "
            "is exact-only)")

    batched = verts_ndc.ndim == 3
    vb = verts_ndc if batched else verts_ndc[None]
    if use_reference:
        alpha = torch.stack([
            soft_silhouette_ref(v, faces, image_size, sigma=sigma, znear=znear) for v in vb
        ])
        return alpha if batched else alpha[0]

    tri = vb[:, faces.long()]                      # (N, F, 3, 3)
    valid = torch.any(tri[..., 2] > znear, dim=-1)
    if approx_max_faces is not None:
        from smilify_tpu_torch.render.rasterizer_worklist import raster_S_worklist

        k_sub = max(1, _cdiv(approx_max_faces, FACE_GROUP))
        S = raster_S_worklist(tri[..., :2], tri[..., 2], valid, image_size, sigma, k_sub)
    else:
        S = raster_S(tri[..., :2], valid, image_size, sigma)
    alpha = 1.0 - torch.exp(-S)
    return alpha if batched else alpha[0]
