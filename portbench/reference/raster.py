"""The soft silhouette in plain PyTorch: SoftRas's log-space sum
S(p) = Σ_f softplus(−d_f(p)/σ), alpha = 1 − exp(−S), σ = 1e-4, with d_f the
signed squared NDC distance from pixel p to triangle f (negative inside),
over the faces that the cull admits to each 32×32 tile.

The cull and the cap are the rule the work-list raster states: faces go in
8-face subgroups in index order; a subgroup is a candidate for a tile when
its bounding box, grown by √(14σ), touches the tile; a capped tile keeps its
``k_sub`` candidates of least depth (the subgroup's least vertex z), as
``torch.topk`` orders them; a face whose three vertices all lie behind the
near plane (z ≤ ``znear``) adds nothing. Uncapped, every candidate counts. A face
beyond the margin adds less than 8.3e-7 to S, which the rule drops.

Gradients flow by autograd to the vertices' (x, y); the depth only orders."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

SIGMA = 1e-4
TILE = 32
GROUP = 8
MARGIN = math.sqrt(14.0 * SIGMA)
ZNEAR = 0.001


def tile_grid(H: int, W: int):
    return -(-H // TILE), -(-W // TILE)


def pixel_ndc(H: int, W: int, device):
    """(n_tiles, 1024) NDC x and y of every pixel of every tile (row-major tiles)."""
    ny, nx = tile_grid(H, W)
    s = float(min(H, W))
    q = torch.arange(TILE * TILE, device=device)
    t = torch.arange(ny * nx, device=device)[:, None]
    rows = (t // nx) * TILE + q // TILE
    cols = (t % nx) * TILE + q % TILE
    return -(cols * 2.0 + 1.0 - W) / s, -(rows * 2.0 + 1.0 - H) / s


def candidates(tri_xy, tri_z, H, W, k_sub=None, znear=ZNEAR):
    """Each tile's subgroups: (idx (N, T, K) long, keep (N, T, K) bool)."""
    N, F = tri_xy.shape[:2]
    pad = (-F) % GROUP
    valid = (tri_z > znear).any(-1)
    big = 1e9

    def grouped(v, fill, op):
        v = torch.nn.functional.pad(v, (0, pad), value=fill)
        return op(v.reshape(N, -1, GROUP), -1).values

    x, y = tri_xy[..., 0], tri_xy[..., 1]
    xmin = grouped(torch.where(valid, x.amin(-1), big), big, torch.min)
    xmax = grouped(torch.where(valid, x.amax(-1), -big), -big, torch.max)
    ymin = grouped(torch.where(valid, y.amin(-1), big), big, torch.min)
    ymax = grouped(torch.where(valid, y.amax(-1), -big), -big, torch.max)
    ny, nx = tile_grid(H, W)
    s = float(min(H, W))
    i = torch.arange(ny, device=x.device, dtype=x.dtype)
    j = torch.arange(nx, device=x.device, dtype=x.dtype)
    t_ymax, t_ymin = -(i * TILE * 2 + 1 - H) / s, -(((i + 1) * TILE - 1) * 2 + 1 - H) / s
    t_xmax, t_xmin = -(j * TILE * 2 + 1 - W) / s, -(((j + 1) * TILE - 1) * 2 + 1 - W) / s
    oy = (ymin[:, None] <= t_ymax[None, :, None] + MARGIN) & (ymax[:, None] >= t_ymin[None, :, None] - MARGIN)
    ox = (xmin[:, None] <= t_xmax[None, :, None] + MARGIN) & (xmax[:, None] >= t_xmin[None, :, None] - MARGIN)
    hit = (oy[:, :, None] & ox[:, None]).reshape(N, ny * nx, -1)            # (N, T, G)
    count = hit.sum(-1)
    if k_sub is None:
        k = max(int(count.max()), 1)
        idx = torch.topk(hit.to(x.dtype), k, dim=-1).indices
    else:
        zmin = torch.where(valid, tri_z.amin(-1), big)
        gz = torch.nn.functional.pad(zmin, (0, pad), value=big).reshape(N, -1, GROUP).amin(-1)
        k = min(k_sub, hit.shape[-1])
        key = torch.where(hit, -gz[:, None, :], -torch.inf)
        idx = torch.topk(key, k, dim=-1).indices
    keep = torch.arange(idx.shape[-1], device=idx.device) < torch.clamp_max(count, k)[..., None]
    return idx, keep


def pairs(tri_xy, tri_z, H, W, k_sub=None, znear=ZNEAR) -> int:
    """(pixel, face) pairs the rule admits: 8 faces × 1024 pixels a kept subgroup."""
    _, keep = candidates(tri_xy, tri_z, H, W, k_sub, znear)
    return int(keep.sum()) * GROUP * TILE * TILE


def _edge(px, py, ax, ay, bx, by):
    ex, ey = bx - ax, by - ay
    dx, dy = px - ax, py - ay
    t = torch.clamp((dx * ex + dy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12), 0.0, 1.0)
    rx, ry = dx - t * ex, dy - t * ey
    return rx * rx + ry * ry, ex * dy - ey * dx


def tile_S(px, py, fa, live):
    """S of P tiles' pixels px, py (P, 1, 1024) against face rows fa (P, M, 7)
    (ax ay bx by cx cy valid), ``live`` (P, M): (P, 1024)."""
    ax, ay, bx, by, cx, cy, ok = (fa[..., k:k + 1] for k in range(7))
    d1, c0 = _edge(px, py, ax, ay, bx, by)
    d2, c1 = _edge(px, py, bx, by, cx, cy)
    d3, c2 = _edge(px, py, cx, cy, ax, ay)
    d = torch.minimum(torch.minimum(d1, d2), d3)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    x = torch.where(inside, d, -d) / SIGMA
    soft = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(live[..., None] & (ok > 0), soft, 0.0).sum(1)


def soft_silhouette(verts_ndc, faces, H, W, k_sub=None, znear=ZNEAR, block_pairs=1 << 25):
    """alpha (N, H, W) of vertices (N, V, 3): NDC x, y and view depth z.
    Tiles go in blocks of at most ``block_pairs`` (pixel, face) pairs; under
    autograd each block is checkpointed: its pairs' terms are recomputed in
    the backward pass, not kept."""
    tri = verts_ndc[:, faces]                                              # (N, F, 3, 3)
    N, F = tri.shape[:2]
    idx, keep = candidates(tri[..., :2].detach(), tri[..., 2].detach(), H, W, k_sub, znear)
    valid = (tri[..., 2] > znear).any(-1, keepdim=True).to(tri.dtype)
    rows = torch.cat([tri[..., :2].reshape(N, F, 6), valid], -1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, (-F) % GROUP))          # (N, F8, 7)
    px, py = pixel_ndc(H, W, verts_ndc.device)
    n_i, t_i = torch.nonzero(keep[..., 0], as_tuple=True)
    faces_of = (idx[n_i, t_i, :, None] * GROUP + torch.arange(GROUP, device=idx.device))
    live = keep[n_i, t_i].repeat_interleave(GROUP, -1)
    ny, nx = tile_grid(H, W)
    S = torch.zeros((N, ny * nx, TILE * TILE), dtype=verts_ndc.dtype, device=verts_ndc.device)
    parts = []
    tile_block = max(1, block_pairs // (faces_of.shape[1] * GROUP * TILE * TILE))
    for lo in range(0, n_i.shape[0], tile_block):
        sl = slice(lo, lo + tile_block)
        fa = rows[n_i[sl, None], faces_of[sl].reshape(faces_of[sl].shape[0], -1)]
        args = (px[t_i[sl], None], py[t_i[sl], None], fa, live[sl])
        parts.append(checkpoint(tile_S, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else tile_S(*args))
    if parts:
        S = S.index_put((n_i, t_i), torch.cat(parts), accumulate=True)
    S = S.reshape(N, ny, nx, TILE, TILE).permute(0, 1, 3, 2, 4).reshape(N, ny * TILE, nx * TILE)
    return 1.0 - torch.exp(-S[:, :H, :W])
