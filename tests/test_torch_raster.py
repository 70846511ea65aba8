"""Parity of the port's soft-silhouette raster (smilify_tpu_torch.render) with
the JAX package on the CPU.

On the CPU the raster wrappers run the plain PyTorch versions of the CUDA
kernels, so these tests hold the plain versions (and the packing, cull and
work-list code around them, which the card runs too) to the JAX kernels run
in interpret mode and to the all-faces oracle. The kernels themselves are
held to the plain versions on the card by ``chip_smoke.py``.

Tolerances: alpha atol 1e-5 against the JAX kernels (same culled work, f32
sums in another order), 1e-4 against the all-faces oracle (the cull drops
faces beyond the blur margin, tests/test_rasterizer.py), and xy gradients
atol 5e-3 / rtol 1e-3 (tests/test_rasterizer.py: the per-pixel terms are
O(1/σ) = 1e4 before the sums, so f32 sums in another order differ there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.render.rasterizer import _raster_S as jax_raster_S
from smilify_tpu.render.rasterizer import soft_silhouette as jax_soft_silhouette
from smilify_tpu.render.rasterizer_worklist import raster_S_worklist as jax_raster_S_worklist

from smilify_tpu_torch.render import rasterizer as R
from smilify_tpu_torch.render import rasterizer_worklist as RW

SIGMA = 1e-4
ALPHA_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 5e-3, 1e-3


def _scene(seed, N, F, spread=0.8, size=0.25):
    """Random triangles (N, F, 3, 2), validity (N, F) and distinct z (N, F, 3)."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(-spread, spread, (N, F, 1, 2))
    tri = (centre + rng.uniform(-size, size, (N, F, 3, 2))).astype(np.float32)
    valid = rng.uniform(size=(N, F)) > 0.1
    z = rng.permutation(N * F * 3).reshape(N, F, 3).astype(np.float32) / (N * F * 3) + 0.5
    return tri, valid, z


def _saturating_scene(N=2, F=600):
    """F copies (jittered by 0.01) of one large triangle, (0, −3), (0, 3),
    (5, 0), over the left tile of a 32×64 image (NDC x > 0) and not the
    right one; z rises with the face index, so the work lists keep face
    order. Every subgroup's bounding box (+ blur margin) touches both
    tiles."""
    rng = np.random.RandomState(7)
    base = np.array([[0.0, -3.0], [0.0, 3.0], [5.0, 0.0]], np.float32)
    tri = (base + rng.uniform(-0.01, 0.01, (N, F, 3, 2))).astype(np.float32)
    z = np.broadcast_to((np.arange(F, dtype=np.float32) / F + 0.5)[None, :, None], (N, F, 3))
    return tri, np.ones((N, F), bool), z.copy()


def _port(fn, tri, *args):
    """Run ``fn(tri_xy, *args)`` on the CPU; S and the tri_xy gradient for a
    fixed random cotangent."""
    t = torch.from_numpy(tri.copy()).requires_grad_(True)
    S = fn(t, *args)
    g = torch.from_numpy(np.random.RandomState(9).standard_normal(S.shape).astype(np.float32))
    (S * g).sum().backward()
    return S.detach().numpy(), t.grad.numpy(), g.numpy()


def _jax_vjp(fn, tri, g):
    S, vjp = jax.vjp(fn, jnp.asarray(tri))
    return np.asarray(S), np.asarray(vjp(jnp.asarray(g))[0])


def _alpha(S):
    return 1.0 - np.exp(-S)


# ---------------------------------------------------------------------------
# exact pair (K1, K2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exact_case():
    """One small case through the JAX exact kernels in interpret mode (slow:
    every grid step is interpreted) and the port's exact raster."""
    tri, valid, _ = _scene(0, 1, 40)
    size = (32, 64)
    S_t, g_t, gS = _port(lambda t: R.raster_S(t, torch.from_numpy(valid), size), tri)
    S_j, g_j = _jax_vjp(lambda t: jax_raster_S(t, jnp.asarray(valid), size, SIGMA, True), tri, gS)
    return S_t, g_t, S_j, g_j


def test_exact_forward_matches_jax_kernel(exact_case):
    S_t, _, S_j, _ = exact_case
    assert S_t.shape == S_j.shape == (1, 32, 64)
    assert S_j.max() > 1.0  # the scene covers pixels
    np.testing.assert_allclose(_alpha(S_t), _alpha(S_j), atol=ALPHA_ATOL)


def test_exact_gradient_matches_jax_vjp(exact_case):
    _, g_t, _, g_j = exact_case
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t, g_j, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("batched", [False, True])
def test_exact_soft_silhouette_matches_jax_oracle(batched):
    """The public entry against the JAX all-faces oracle, over several tiles
    and chunks (F > 512 so the cull words of two chunks are used)."""
    rng = np.random.RandomState(1)
    N, V, F = 2, 400, 700
    verts = np.concatenate([rng.uniform(-1.1, 1.1, (N, V, 2)),
                            rng.uniform(0.5, 2.0, (N, V, 1))], -1).astype(np.float32)
    verts[:, :, :2] *= 0.6
    faces = np.stack([np.arange(F) % V, (np.arange(F) + 1) % V, (np.arange(F) * 7 + 3) % V], -1)
    faces = faces.astype(np.int32)
    verts[0, :5, 2] = -1.0  # behind the camera: faces made only of these are culled
    size = (64, 96)
    v = verts if batched else verts[0]
    a_j = np.asarray(jax_soft_silhouette(jnp.asarray(v), jnp.asarray(faces), size, znear=0.0,
                                         use_pallas=False))
    a_t = R.soft_silhouette(torch.from_numpy(v), torch.from_numpy(faces), size).numpy()
    assert a_t.shape == a_j.shape
    assert a_j.max() > 0.99
    np.testing.assert_allclose(a_t, a_j, atol=1e-4)


def test_reference_raster_matches_jax_oracle():
    tri, valid, _ = _scene(2, 1, 30)
    verts = np.concatenate([tri.reshape(-1, 2), np.ones((90, 1), np.float32)], -1)
    faces = np.arange(90, dtype=np.int32).reshape(30, 3)
    a_j = np.asarray(jax_soft_silhouette(jnp.asarray(verts), jnp.asarray(faces), (40, 48),
                                         use_pallas=False))
    a_t = R.soft_silhouette(torch.from_numpy(verts), torch.from_numpy(faces), (40, 48),
                            use_reference=True).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "worklist"])
def test_saturating_forward_matches_jax_oracle(mode):
    """The saturation early-out at a batch boundary. In _saturating_scene
    (F = 600: two cull chunks, 75 subgroups) the left tile's S passes
    SATURATION_S everywhere within the first chunk (64 subgroups) and the
    exact forward stops there; the right tile has all 75 cull bits but S ~0
    over most of it, so it runs them all. The work-list forward (uncapped,
    z in face order) stops the left tile after its first 64-entry batch.
    The forward wrappers (plain versions on the CPU) count exactly those
    subgroups in ``work``, and their alpha is the all-faces oracle's."""
    tri, valid, z = _saturating_scene()
    H, W = 32, 64
    t, v = torch.from_numpy(tri), torch.from_numpy(valid)
    work = torch.full((4,), -1, dtype=torch.int32)   # written, not added to
    if mode == "exact":
        S = R.exact_fwd(R._pack_faces(t, v), R._tile_cull_mask(t, v, H, W, SIGMA), H, W, SIGMA,
                        work=work)
    else:
        idx, cnt = RW._tile_worklists(t, torch.from_numpy(z), v, H, W, SIGMA, 80)
        S = RW.worklist_fwd(RW._pack_faces_flat(t, v), idx, cnt, H, W, SIGMA, work=work)
    assert work.tolist() == [64, 75, 64, 75]
    verts = np.concatenate([tri.reshape(2, -1, 2), z.reshape(2, -1, 1)], -1)
    faces = np.arange(verts.shape[1], dtype=np.int32).reshape(-1, 3)
    a_j = np.asarray(jax_soft_silhouette(jnp.asarray(verts), jnp.asarray(faces), (H, W),
                                         znear=0.0, use_pallas=False))
    assert a_j[:, :, :32].min() > 1 - 1e-6 and a_j[:, :, 32:].min() < 1e-6
    np.testing.assert_allclose(_alpha(R._tiles_to_image(S, H, W).numpy()), a_j, atol=1e-4)


# ---------------------------------------------------------------------------
# work-list pair (K3, K4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_sub", [16, 2], ids=["uncapped", "capped"])
def test_worklist_matches_jax_kernel(k_sub):
    """k_sub=16 lists every overlapping subgroup; k_sub=2 truncates the lists
    (checked), so the nearest-z order decides which subgroups stay."""
    tri, valid, z = _scene(3, 2, 40)
    size = (64, 64)
    _, count = RW._tile_worklists(torch.from_numpy(tri), torch.from_numpy(z),
                                  torch.from_numpy(valid), *size, SIGMA, 16)
    n_overlap = int(count.max())
    assert (n_overlap <= k_sub) == (k_sub == 16), n_overlap
    args = (torch.from_numpy(z), torch.from_numpy(valid), size, SIGMA, k_sub)
    S_t, g_t, gS = _port(RW.raster_S_worklist, tri, *args)
    S_j, g_j = _jax_vjp(lambda t: jax_raster_S_worklist(
        t, jnp.asarray(z), jnp.asarray(valid), size, SIGMA, k_sub, True), tri, gS)
    assert S_j.max() > 1.0
    np.testing.assert_allclose(_alpha(S_t), _alpha(S_j), atol=ALPHA_ATOL)
    np.testing.assert_allclose(g_t, g_j, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_worklist_lists_match_jax_order():
    """The same work lists (nearest z first) as the JAX package's top_k."""
    from smilify_tpu.render.rasterizer_worklist import _tile_worklists as jax_lists

    tri, valid, z = _scene(4, 2, 64)
    idx_j, cnt_j = jax_lists(jnp.asarray(tri), jnp.asarray(z), jnp.asarray(valid),
                             64, 96, SIGMA, 5)
    idx_t, cnt_t = RW._tile_worklists(torch.from_numpy(tri), torch.from_numpy(z),
                                      torch.from_numpy(valid), 64, 96, SIGMA, 5)
    cnt_j, idx_j = np.asarray(cnt_j), np.asarray(idx_j)
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    live = np.arange(5)[None, None] < cnt_j[..., None]
    np.testing.assert_array_equal(idx_t.numpy()[live], idx_j[live])


@pytest.mark.parametrize("direction", ["fwd", "fwd_saturating", "bwd"])
def test_plain_worklist_uncapped_equals_plain_exact(direction):
    """Uncapped, both plain versions do the same work: the same S and the
    same subgroups counted, and the same face gradients. F = 600 spans two
    cull chunks and k_sub = 75 more than one 64-entry batch, so the sums
    cross the chunk and list boundaries where the backward kernels cut a
    tile's work over blocks. ``fwd_saturating`` (_saturating_scene) stops
    one tile at those boundaries: after the first chunk (exact) and the
    first batch (work list), the same 64 subgroups."""
    if direction == "fwd_saturating":
        tri, valid, z = _saturating_scene()
    else:
        tri, valid, z = _scene(5, 2, 600, spread=0.9, size=0.1)
    t, v = torch.from_numpy(tri), torch.from_numpy(valid)
    H, W = 32, 64
    T = R._tile_grid(H, W)[2]
    face, mask = R._pack_faces(t, v), R._tile_cull_mask(t, v, H, W, SIGMA)
    flat = RW._pack_faces_flat(t, v)
    idx, cnt = RW._tile_worklists(t, torch.from_numpy(z), v, H, W, SIGMA, 75)
    assert face.shape[1] == 2 and int(cnt.max()) > R.GROUPS_PER_CHUNK, int(cnt.max())
    if direction.startswith("fwd"):
        w_e, w_w = (torch.zeros(2 * T, dtype=torch.int32) for _ in range(2))
        S_e = R.exact_fwd_plain(face, mask, H, W, SIGMA, work=w_e)
        S_w = RW.worklist_fwd_plain(flat, idx, cnt, H, W, SIGMA, work=w_w)
        np.testing.assert_allclose(_alpha(S_w.numpy()), _alpha(S_e.numpy()), atol=1e-6)
        np.testing.assert_array_equal(w_w.numpy(), w_e.numpy())
        stopped = int((w_e < cnt.reshape(-1)).sum())
        assert stopped == (2 if direction == "fwd_saturating" else 0), w_e
        return
    # the silhouette term's cotangent scale (w_reproj 1000 over H·W pixels)
    gS = np.random.RandomState(6).standard_normal((2, T, R.TILE_PIX)) * (1000.0 / (H * W))
    gS = torch.from_numpy(gS.astype(np.float32))
    d_e = R.exact_bwd_plain(face, mask, gS, H, W, SIGMA).reshape(2, -1, 8)[:, :600]
    d_w = RW.worklist_bwd_plain(flat, idx, cnt, gS, H, W, SIGMA)
    assert float(d_e.abs().max()) > 0
    np.testing.assert_allclose(d_w.numpy(), d_e.numpy(), atol=1e-5, rtol=1e-5)


def test_approx_cap_rejects_reference_raster():
    v = torch.zeros((3, 3))
    f = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="work-list"):
        R.soft_silhouette(v, f, (32, 32), use_reference=True, approx_max_faces=800)


def test_auto_cap_off_the_card():
    assert R.auto_approx_max_faces((512, 512), device="cpu") is None


def test_wrappers_never_fall_back_to_plain():
    """A tensor that is not on the CPU goes to the kernel or raises; it never
    reaches the plain version."""
    face = torch.zeros((1, 1, R.FACE_CHUNK, 8), device="meta")
    mask = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        R.exact_fwd(face, mask, 32, 32, SIGMA)
    flat = torch.zeros((1, 8, 8), device="meta")
    idx = torch.zeros((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        RW.worklist_fwd(flat, idx, idx[..., 0], 32, 32, SIGMA)
