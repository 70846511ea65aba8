"""Parity of the port's 3D registration (smilify_tpu_torch.ops, fitter3d and
their CLIs) with the JAX package on the CPU.

The same numpy inputs go through both packages. Where the JAX function draws
from a PRNG key, the test draws the same numbers with ``jax.random`` the way
the function does and hands them to the port's deterministic half
(``points_from_uniforms``, ``sdf_from_draws``, ``registration_losses(...,
uniforms=...)``). Tolerance: 1e-5 on values and gradients (both sides run
float32 with full-precision matmuls), 1e-4 on parameters after a few Adam
steps; indices and topology arrays exactly.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import ast
import os
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.fitter import fitter3d as J3
from smilify_tpu.ops import knn as jknn
from smilify_tpu.ops import mesh_ops as jmo
from smilify_tpu.ops import sdf as jsdf
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec
from smilify_tpu.utils.export import save_obj

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter3d as T3
from smilify_tpu_torch.ops import knn as tknn
from smilify_tpu_torch.ops import mesh_ops as tmo
from smilify_tpu_torch.ops import sdf as tsdf
from smilify_tpu_torch.tools import bench_all
from smilify_tpu_torch.tools.synthetic_data import posed_target_meshes

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=err_msg)


@pytest.fixture(scope="module")
def specs():
    return jax_toy_spec(8, 6, 3), toy_model_spec(8, 6, 3, device="cpu")


def _clouds(seed=0, n=40, m=50, batch=()):
    rng = np.random.RandomState(seed)
    return (rng.randn(*batch, n, 3).astype(np.float32),
            (rng.randn(*batch, m, 3) + 0.3).astype(np.float32))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_points_matches_jax(K, tiled, masked):
    x, y = _clouds()
    kw = {"oneshot_elems": 100, "tile": 16} if tiled else {}
    masks = {}
    if masked:
        rng = np.random.RandomState(1)
        masks = {"x_mask": rng.rand(40) > 0.2, "y_mask": rng.rand(50) > 0.3}
    want = jknn.knn_points(jnp.asarray(x), jnp.asarray(y), K=K,
                           **{k: jnp.asarray(v) for k, v in masks.items()}, **kw)
    got = tknn.knn_points(_t(x), _t(y), K=K, **{k: _t(v) for k, v in masks.items()}, **kw)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    _close(got.dists, want.dists)
    _close(got.knn, want.knn)


def test_knn_points_batched_matches_jax():
    x, y = _clouds(2, batch=(3,))
    want = jknn.knn_points(jnp.asarray(x), jnp.asarray(y), K=2)
    got = tknn.knn_points(_t(x), _t(y), K=2)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    _close(got.dists, want.dists)
    # batched masks (the JAX function takes them one cloud at a time)
    rng = np.random.RandomState(3)
    xm, ym = rng.rand(3, 40) > 0.2, rng.rand(3, 50) > 0.3
    got = tknn.knn_points(_t(x), _t(y), K=2, x_mask=_t(xm), y_mask=_t(ym))
    for b in range(3):
        want = jknn.knn_points(jnp.asarray(x[b]), jnp.asarray(y[b]), K=2,
                               x_mask=jnp.asarray(xm[b]), y_mask=jnp.asarray(ym[b]))
        np.testing.assert_array_equal(got.idx[b].numpy(), np.asarray(want.idx))
        _close(got.dists[b], want.dists)


def test_knn_envelope_gradient_matches_jax_and_full():
    """tests/test_ops.py::test_knn_envelope_gradient_matches_full, on the
    port: the chamfer gradient through the gathered neighbours equals the
    JAX one and the one through the full distance matrix."""
    x, y = _clouds(11)

    def chamfer(a, b):
        return (torch.mean(tknn.knn_points(a, b, K=1).dists)
                + torch.mean(tknn.knn_points(b, a, K=1).dists))

    def chamfer_full(a, b):
        d = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
        return torch.mean(d.min(1).values) + torch.mean(d.min(0).values)

    def jchamfer(a, b):
        return (jnp.mean(jknn.knn_points(a, b, K=1).dists)
                + jnp.mean(jknn.knn_points(b, a, K=1).dists))

    jx, jy = jax.grad(jchamfer, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    for fn in (chamfer, chamfer_full):
        a, b = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
        fn(a, b).backward()
        _close(a.grad, jx)
        _close(b.grad, jy)


def test_topology_arrays_equal_jax(specs):
    faces = specs[1].faces.numpy()
    np.testing.assert_array_equal(tmo.edges_from_faces(faces), jmo.edges_from_faces(faces))
    for got, want in zip(tmo.laplacian_neighbors_from_faces(faces, specs[1].n_verts),
                         jmo.laplacian_neighbors_from_faces(faces, specs[1].n_verts)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmo.face_adjacency_from_faces(faces),
                                  jmo.face_adjacency_from_faces(faces))


def _mesh(specs, seed=3):
    v = np.asarray(specs[1].v_template) + np.random.RandomState(seed).randn(
        specs[1].n_verts, 3).astype(np.float32) * 0.01
    return v.astype(np.float32), specs[1].faces.numpy().astype(np.int32)


@pytest.mark.parametrize("loss", ["chamfer", "chamfer_masked", "edge", "laplacian", "normal"])
def test_losses_and_gradients_match_jax(specs, loss):
    v, f = _mesh(specs)
    x, y = _clouds(5, batch=(2,))
    masks = (np.random.RandomState(6).rand(2, 40) > 0.2, np.random.RandomState(7).rand(2, 50) > 0.2)
    table, deg = jmo.laplacian_neighbors_from_faces(f, len(v))
    adj = jmo.face_adjacency_from_faces(f)
    edges = jmo.edges_from_faces(f)
    cases = {
        "chamfer": ((x, y), lambda a, b: jmo.chamfer_distance(a, b),
                    lambda a, b: tmo.chamfer_distance(a, b)),
        "chamfer_masked": ((x, y),
                           lambda a, b: jmo.chamfer_distance(a, b, *map(jnp.asarray, masks)),
                           lambda a, b: tmo.chamfer_distance(a, b, *map(_t, masks))),
        "edge": ((v,), lambda a: jmo.mesh_edge_loss(a, jnp.asarray(edges)),
                 lambda a: tmo.mesh_edge_loss(a, _t(edges).long())),
        "laplacian": ((v,), lambda a: jmo.mesh_laplacian_smoothing(a, jnp.asarray(table),
                                                                   jnp.asarray(deg)),
                      lambda a: tmo.mesh_laplacian_smoothing(a, _t(table).long(), _t(deg))),
        "normal": ((v,), lambda a: jmo.mesh_normal_consistency(a, jnp.asarray(adj)),
                   lambda a: tmo.mesh_normal_consistency(a, _t(adj).long())),
    }
    args, jfn, tfn = cases[loss]
    jargs = [jnp.asarray(a) for a in args]
    want = jfn(*jargs)
    jgrads = jax.grad(jfn, argnums=tuple(range(len(args))))(*jargs)
    targs = [_t(a).requires_grad_(True) for a in args]
    got = tfn(*targs)
    got.backward()
    _close(got, want)
    for t, g in zip(targs, jgrads):
        _close(t.grad, g)


def _jax_sample_draws(key, num_samples):
    """The uniforms ``sample_points_from_meshes`` draws from ``key``
    (smilify_tpu/ops/mesh_ops.py:206-212)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (num_samples,))),
            np.asarray(jax.random.uniform(k2, (num_samples, 2))))


@pytest.mark.parametrize("face_mask", [False, True])
def test_sampling_given_jax_uniforms_matches_jax(specs, face_mask):
    v, f = _mesh(specs)
    mask = np.random.RandomState(8).rand(len(f)) > 0.3 if face_mask else None
    key = jax.random.PRNGKey(4)
    want = jmo.sample_points_from_meshes(jnp.asarray(v), jnp.asarray(f), 300, key,
                                         return_normals=True,
                                         face_mask=None if mask is None else jnp.asarray(mask))
    r, u = _jax_sample_draws(key, 300)
    vt = _t(v).requires_grad_(True)
    got = tmo.points_from_uniforms(vt, _t(f), _t(r), _t(u), return_normals=True,
                                   face_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.face_idx.numpy(), np.asarray(want.face_idx))
    _close(got.points, want.points)
    _close(got.normals, want.normals)
    if mask is not None:
        assert mask[got.face_idx.numpy()].all()
    jgrad = jax.grad(lambda a: jnp.sum(jmo.sample_points_from_meshes(
        a, jnp.asarray(f), 300, key, face_mask=None if mask is None else jnp.asarray(mask))
        ** 2))(jnp.asarray(v))
    torch.sum(got.points ** 2).backward()
    _close(vt.grad, jgrad)
    # the port's own draws: the same generator seed gives the same points
    a = tmo.sample_points_from_meshes(_t(v), _t(f), 50, torch.Generator().manual_seed(1))
    b = tmo.sample_points_from_meshes(_t(v), _t(f), 50, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("shared_faces", [True, False])
def test_batched_sampling_sdf_and_thinness_match_jax_per_mesh(specs, shared_faces):
    """The batched forms (one call over B meshes, as ``registration_losses``
    makes them) against the JAX functions called on each mesh."""
    B, S = 3, 200
    meshes = [_mesh(specs, seed) for seed in range(B)]
    v = np.stack([m[0] for m in meshes])
    f = meshes[0][1]
    mask = None if shared_faces else np.random.RandomState(8).rand(B, len(f)) > 0.3
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    draws = [_jax_sample_draws(k, S) for k in keys]
    vt = _t(v).requires_grad_(True)
    got = tmo.points_from_uniforms(
        vt, _t(f) if shared_faces else _t(np.stack([f] * B)),
        _t(np.stack([d[0] for d in draws])), _t(np.stack([d[1] for d in draws])),
        return_normals=True, face_mask=None if mask is None else _t(mask))
    torch.sum(got.points ** 2).backward()
    for b in range(B):
        fm = None if mask is None else jnp.asarray(mask[b])
        want = jmo.sample_points_from_meshes(jnp.asarray(v[b]), jnp.asarray(f), S, keys[b],
                                             return_normals=True, face_mask=fm)
        np.testing.assert_array_equal(got.face_idx[b].numpy(), np.asarray(want.face_idx))
        _close(got.points[b], want.points)
        _close(got.normals[b], want.normals)
        jgrad = jax.grad(lambda a: jnp.sum(jmo.sample_points_from_meshes(
            a, jnp.asarray(f), S, keys[b], face_mask=fm) ** 2))(jnp.asarray(v[b]))
        _close(vt.grad[b], jgrad)

    x, y = _clouds(12, n=30, m=30, batch=(B,))
    xs, ys = np.random.RandomState(13).rand(2, B, 30).astype(np.float32)
    got = tsdf.sdf_distance(_t(x), _t(y), _t(xs), _t(ys), k=4)
    thin = tmo.compute_thinness_scores(_t(v), _t(f), n_neighbors=6)
    for b in range(B):
        _close(got[b], jsdf.sdf_distance(*map(jnp.asarray, (x[b], y[b], xs[b], ys[b])), k=4))
        _close(thin[b], jmo.compute_thinness_scores(jnp.asarray(v[b]), jnp.asarray(f),
                                                    n_neighbors=6))


def test_sdf_given_jax_draws_matches_jax(specs):
    v, f = _mesh(specs)
    S, R = 48, 6
    key = jax.random.PRNGKey(9)
    want_pts, want_diam = jsdf.compute_sdf(jnp.asarray(v), jnp.asarray(f), key,
                                           num_samples=S, num_rays=R, point_chunk=16)
    k1, k2 = jax.random.split(key)
    r, u = _jax_sample_draws(k1, S)
    d = np.asarray(jax.random.normal(k2, (S, R, 3)))
    pts, diam = tsdf.sdf_from_draws(_t(v), _t(f), _t(r), _t(u), _t(d), point_chunk=20,
                                    face_chunk=50)
    _close(pts, want_pts)
    _close(diam, want_diam)
    assert float(diam.max()) > float(diam.min())           # some rays hit the far wall

    smoothed = tsdf.smooth_sdf(pts, diam, k=8)
    _close(smoothed, jsdf.smooth_sdf(want_pts, want_diam, k=8))
    _close(tsdf.assign_vertex_sdf(_t(v), pts, smoothed, k=4),
           jsdf.assign_vertex_sdf(jnp.asarray(v), want_pts, jsdf.smooth_sdf(want_pts, want_diam, k=8), k=4))
    _close(tmo.compute_thinness_scores(_t(v), _t(f), n_neighbors=6),
           jmo.compute_thinness_scores(jnp.asarray(v), jnp.asarray(f), n_neighbors=6))

    x, y = _clouds(12, n=30, m=30)
    xs, ys = np.random.RandomState(13).rand(2, 30).astype(np.float32)
    jfn = lambda a: jsdf.sdf_distance(a, jnp.asarray(y), jnp.asarray(xs), jnp.asarray(ys), k=4)  # noqa: E731
    xt = _t(x).requires_grad_(True)
    got = tsdf.sdf_distance(xt, _t(y), _t(xs), _t(ys), k=4)
    got.backward()
    _close(got, jfn(jnp.asarray(x)))
    _close(xt.grad, jax.grad(jfn)(jnp.asarray(x)))

    normals = np.random.RandomState(14).randn(5, 3).astype(np.float32)
    dirs = tsdf.hemisphere_directions(_t(normals), 7, torch.Generator().manual_seed(0))
    assert (torch.sum(dirs * _t(normals)[:, None], -1) <= 0).all()
    _close(torch.linalg.norm(dirs, dim=-1), np.ones((5, 7)))


def _jax_params(spec, B, seed=21):
    rng = np.random.RandomState(seed)
    J, P, V = spec.n_joints, spec.n_joints - 1, spec.n_verts
    return {
        "global_rot": rng.uniform(-0.2, 0.2, (B, 3)),
        "joint_rot": rng.uniform(-0.1, 0.1, (B, P, 3)),
        "betas": rng.uniform(-0.3, 0.3, (B, spec.n_betas)),
        "trans": rng.uniform(-0.05, 0.05, (B, 3)),
        "log_beta_scales": rng.uniform(-0.1, 0.1, (B, J, 3)),
        "betas_trans": rng.uniform(-0.02, 0.02, (B, J, 3)),
        "deform_verts": rng.uniform(-0.005, 0.005, (B, V, 3)),
    }


def _targets(specs, B):
    faces = specs[1].faces.numpy().astype(np.int32)
    meshes = [(v, faces[: len(faces) - 4 * i]) for i, v in enumerate(posed_target_meshes(specs[1], B))]
    names = [f"t{i}" for i in range(B)]
    return J3.pad_target_meshes(meshes, names), T3.pad_target_meshes(meshes, names, device="cpu")


def test_registration_losses_given_the_same_samples_match_jax(specs):
    jspec, tspec = specs
    B, S = 2, 200
    arrays = {k: v.astype(np.float32) for k, v in _jax_params(jspec, B).items()}
    jt, tt = _targets(specs, B)
    key = jax.random.PRNGKey(3)
    lw = {"chamfer": 1.0, "edge": 1.0, "normal": 0.01, "laplacian": 0.1, "sdf": 0.0}
    jtopo = J3.template_topology(jspec)

    def jloss(p):
        return J3.registration_losses(jspec, jtopo, p, jt, key, lw, num_samples=S)

    jp = J3.Fit3DParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    (jtotal, jobjs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    # registration_losses' draws: keys split 2B ways, then within each sampling call
    keys = jax.random.split(key, 2 * B).reshape(B, 2, -1)
    draws = [[_jax_sample_draws(keys[b, i], S) for b in range(B)] for i in range(2)]
    uniforms = tuple(_t(np.stack([d[b][j] for b in range(B)])) for d in draws for j in range(2))
    tp = T3.fit3d_params_from_numpy(arrays, device="cpu")
    for k in tp.fields():
        getattr(tp, k).requires_grad_(True)
    ttotal, tobjs = T3.registration_losses(tspec, T3.template_topology(tspec), tp, tt, None, lw,
                                           num_samples=S, uniforms=uniforms)
    ttotal.backward()
    assert set(tobjs) == set(jobjs) == {"chamfer", "edge", "normal", "laplacian"}
    for k in jobjs:
        _close(tobjs[k], jobjs[k], err_msg=k)
    _close(ttotal, jtotal)
    for k in tp.fields():
        g = np.asarray(getattr(jgrads, k))
        _close(getattr(tp, k).grad, g, tol=TOL * max(1.0, float(np.abs(g).max())), err_msg=k)


def _stages(module):
    """Two stages of the sampling-free losses: free per-vertex deformation,
    then the pose/shape scheme with global_rot and trans (which these losses
    do not see: their gradients are rounding noise, which Adam would blow up
    to ±lr a step) held at lr 1e-6, and joint_rot in its own group."""
    lw = {"chamfer": 0.0, "edge": 1.0, "normal": 0.01, "laplacian": 0.1, "sdf": 0.0}
    return [module.Stage("s0", "deform", n_its=3, lr=0.01, loss_weights=lw),
            module.Stage("s1", "default", n_its=3, lr=0.01, loss_weights=lw,
                         custom_lrs={"global_rot": 1e-6, "trans": 1e-6, "joint_rot": 0.005})]


def test_stage_manager_sampling_free_matches_jax(specs):
    jspec, tspec = specs
    arrays = {k: v.astype(np.float32) for k, v in _jax_params(jspec, 2).items()}
    jt, tt = _targets(specs, 2)
    jm = J3.StageManager(jspec, jt, J3.Fit3DParams(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    tm = T3.StageManager(tspec, tt, T3.fit3d_params_from_numpy(arrays, device="cpu"))
    for st in _stages(J3):
        jm.add_stage(st)
    for st in _stages(T3):
        tm.add_stage(st)
    jm.run()
    seen = []
    tm.run(callback=lambda s, it, loss, objs: seen.append((s, it)), chunk=2)
    assert seen == [(s, i) for s in ("s0", "s1") for i in range(3)]
    for k in tm.params.fields():
        _close(getattr(tm.params, k), getattr(jm.params, k), tol=1e-4, err_msg=k)
    for js, ts in zip(jm.stages, tm.stages):
        for jh, th in zip(js.loss_history, ts.loss_history):
            assert set(jh) == set(th)
            for k in jh:
                np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)


def test_chamfer_falls_on_scaled_self_and_save_npz(specs, tmp_path):
    tspec = specs[1]
    v = tspec.v_template.numpy() * 1.15 + np.array([0.05, -0.03, 0.02], np.float32)
    tt = T3.pad_target_meshes([(v, tspec.faces.numpy())], ["self"], device="cpu")
    mgr = T3.StageManager(tspec, tt, seed=0)
    lw = {"chamfer": 1.0, "edge": 0.0, "normal": 0.0, "laplacian": 0.0, "sdf": 0.0}
    mgr.add_stage(T3.Stage("init", "init", n_its=15, lr=0.02, loss_weights=lw, num_samples=400))
    mgr.add_stage(T3.Stage("shape", "init_rot_lock_trans_scale", n_its=25, lr=0.02,
                           loss_weights=lw, num_samples=400))
    chamfer = []
    mgr.run(callback=lambda s, i, loss, objs: chamfer.append(objs["chamfer"]), chunk=5)
    assert np.mean(chamfer[-5:]) <= 0.5 * np.mean(chamfer[:5]), (chamfer[:5], chamfer[-5:])
    data = np.load(mgr.save_npz(str(tmp_path), "final"))
    assert set(data.files) == {*T3.Fit3DParams.fields(), "verts", "joints", "faces", "labels"}
    assert data["verts"].shape == (1, tspec.n_verts, 3) and list(data["labels"]) == ["self"]


def _write_meshes(specs, mesh_dir):
    os.makedirs(mesh_dir)
    faces = specs[1].faces.numpy()
    for i, v in enumerate(posed_target_meshes(specs[1], 2, seed=5)):
        save_obj(os.path.join(mesh_dir, f"scan{i}.obj"), v, faces)


def test_optimise_3d_and_sdf_batch_clis_match_jax_outputs(specs, tmp_path):
    from smilify_tpu.cli import optimise_3d as jcli
    from smilify_tpu.cli import sdf_batch as jsdf_cli
    from smilify_tpu_torch.cli import optimise_3d as tcli
    from smilify_tpu_torch.cli import sdf_batch as tsdf_cli
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    model = write_model_pkl(str(tmp_path / "toy.pkl"), specs[1])
    mesh_dir = str(tmp_path / "meshes")
    _write_meshes(specs, mesh_dir)
    stage1 = ("  Stage1:\n    scheme: default\n    nits: 2\n    lr: 0.01\n"
              "    loss_weights: {w_chamfer: 1.0, w_edge: 0.5}\n"
              "    custom_lrs: {joint_rot: 0.005}\n")
    yaml_src = tmp_path / "cfg.yaml"
    yaml_src.write_text("stages:\n  Stage0:\n    scheme: init\n    nits: 2\n    lr: 0.05\n" + stage1)
    stages, _ = tcli.load_stages_from_yaml(str(yaml_src))
    assert [(s.name, s.scheme, s.n_its, s.custom_lrs, s.loss_weights["edge"]) for s in stages] == [
        ("Stage0", "init", 2, {}, 1.0), ("Stage1", "default", 2, {"joint_rot": 0.005}, 0.5)]
    yaml_src.write_text("stages:\n" + stage1)      # one stage: one JAX compile
    # the JAX CLI fits both scans in one batch; the port in two, whose npz
    # files it merges into the same shapes
    out = {}
    for name, cli, extra in (("jax", jcli, ["--batch_size", "-1"]),
                             ("port", tcli, ["--batch_size", "1", "--device", "cpu"])):
        cli.main(["--model", model, "--mesh_dir", mesh_dir, "--yaml_src", str(yaml_src),
                  "--results_dir", str(tmp_path / name), "--num_samples", "64",
                  "--iter-chunk", "2"] + extra)
        out[name] = np.load(tmp_path / name / ("batch_0/Stage1.npz" if name == "jax"
                                               else "Stage1.npz"))
    for b in (0, 1):
        assert (tmp_path / "port" / f"batch_{b}" / "loss_components.png").exists()
    assert set(out["port"].files) == set(out["jax"].files)
    for k in out["jax"].files:
        assert out["port"][k].shape == out["jax"][k].shape, k
        assert np.isfinite(out["port"][k]).all() if out["port"][k].dtype.kind == "f" else True
    np.testing.assert_array_equal(out["port"]["labels"], out["jax"]["labels"])
    np.testing.assert_array_equal(out["port"]["faces"], out["jax"]["faces"])

    pkls = {}
    for name, cli in (("jax", jsdf_cli), ("port", tsdf_cli)):
        args = ["--mesh_dir", mesh_dir, "--output", str(tmp_path / f"{name}.pkl"),
                "--num-samples", "64", "--num-rays", "8", "--smooth-k", "16", "--assign-k", "4"]
        with open(cli.main(args + (["--device", "cpu"] if name == "port" else [])), "rb") as f:
            pkls[name] = pickle.load(f)
    assert set(pkls["port"]) == set(pkls["jax"]) == {"scan0", "scan1"}
    for mesh, want in pkls["jax"].items():
        got = pkls["port"][mesh]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (mesh, k)
            assert np.isfinite(got[k]).all()


def _returned_keys(path, func):
    """Keys of the dict literal that ``func`` of ``path`` returns."""
    tree = ast.parse((REPO / path).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].value.keys}


def test_bench_fitter3d_runs_with_the_jax_keys(specs, tmp_path):
    """bench_all config2 rehearsed on the CPU at the toy size."""
    v = posed_target_meshes(specs[1], 1, seed=2)[0]
    obj = str(tmp_path / "target.obj")
    save_obj(obj, v, specs[1].faces.numpy())
    report = bench_all.run(specs[1], only=["config2"], repeats=1, target_s=0.0, target_obj=obj)
    assert set(report) == {"config2_fitter3d_atta"}
    res = report["config2_fitter3d_atta"]
    assert set(res) == _returned_keys("tools/bench_all.py", "bench_fitter3d")
    assert res["target_verts"] == specs[1].n_verts and res["samples"] == 3000
    assert np.isfinite(res["step_ms"]) and res["step_ms"] > 0


def test_bench_all_runs_config2_only_given_a_target(specs, tmp_path):
    """The repository holds no target scan: without ``--target-obj`` a run
    skips config2 and keeps the others, and ``--only config2`` is refused."""
    report = bench_all.run(specs[1], only=["config1", "config2"], repeats=1, target_s=0.0)
    assert set(report) == {"config1_smil_forward_stick"}
    with pytest.raises(SystemExit):
        bench_all.main(["--only", "config2", "--device", "cpu", "--out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()


# ---------------------------------------------------------------------------
# ops/gather.py: the gathers whose backward adds in an order fixed by the
# indices (registration reproducible on the card)
# ---------------------------------------------------------------------------


def _topology_indices(spec):
    """(name, index, valid) of every fixed-topology gather of the template."""
    faces = spec.faces.numpy()
    table, deg = tmo.laplacian_neighbors_from_faces(faces, spec.n_verts)
    return [("edges", tmo.edges_from_faces(faces), None),
            ("nbr_table", table, np.arange(table.shape[1])[None, :] < deg[:, None]),
            ("adjacency", tmo.face_adjacency_from_faces(faces), None),
            ("faces", faces, None)]


@pytest.mark.parametrize("which", range(4))
def test_inverse_tables_equal_a_numpy_construction(specs, which):
    from smilify_tpu_torch.ops.gather import inverse_table

    spec = specs[1]
    name, index, valid = _topology_indices(spec)[which]
    got = inverse_table(index, spec.n_verts, valid)
    flat = np.asarray(index).reshape(-1)
    ok = np.ones(flat.size, bool) if valid is None else np.asarray(valid).reshape(-1)
    lists = [[p for p in range(flat.size) if ok[p] and flat[p] == r] for r in range(spec.n_verts)]
    want = np.full((spec.n_verts, max(map(len, lists))), flat.size, np.int64)
    for r, ps in enumerate(lists):
        want[r, :len(ps)] = ps
    np.testing.assert_array_equal(got, want, err_msg=name)
    table = getattr(T3.template_topology(spec), name)
    np.testing.assert_array_equal(table.index.numpy(), index, err_msg=name)
    np.testing.assert_array_equal(table.inverse.numpy(), want, err_msg=name)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("route", ["table", "tensor"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_gather_rows_forward_bitwise_backward_within_1e6(specs, which, route, batch):
    from smilify_tpu_torch.ops.gather import RowIndex, gather_rows

    spec = specs[1]
    name, index, valid = _topology_indices(spec)[which]
    idx = torch.from_numpy(np.asarray(index, np.int64))
    table = RowIndex.build(index, spec.n_verts, valid) if route == "table" else idx
    rng = np.random.RandomState(which)
    x = _t(rng.randn(*batch, spec.n_verts, 3).astype(np.float32))
    up = _t(rng.randn(*batch, *idx.shape, 3).astype(np.float32))
    if valid is not None:           # a padded position's gradient is zero by construction
        up = up * _t(valid.astype(np.float32))[..., None]
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = gather_rows(a, table), b[..., idx, :]
    assert torch.equal(got, want) and torch.equal(got, b.index_select(-2, idx.reshape(-1))
                                                  .view(*batch, *idx.shape, 3))
    (got * up).sum().backward()
    (want * up).sum().backward()
    assert _rel(a.grad, b.grad) <= 1e-6, name


@pytest.mark.parametrize("batch", [(), (2,)])
def test_take_rows_forward_bitwise_backward_within_1e6(batch):
    """Per-call indices with repeats and rows read by no index (their
    gradient is 0), against take_along_dim and its default backward."""
    from smilify_tpu_torch.ops.gather import take_rows

    rng = np.random.RandomState(4)
    x = _t(rng.randn(*batch, 30, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, (*batch, 200)))
    up = _t(rng.randn(*batch, 200, 3).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = take_rows(a, idx), torch.take_along_dim(b, idx[..., None], dim=-2)
    assert torch.equal(got, want)
    (got * up).sum().backward()
    (want * up).sum().backward()
    assert _rel(a.grad, b.grad) <= 1e-6
    assert torch.equal(a.grad[..., 20:, :], torch.zeros_like(a.grad[..., 20:, :]))
