"""Parity of the port's neural models with the JAX package on the CPU.

The JAX modules run in float32 (``compute_dtype=jnp.float32``); their
variables are seeded random draws of every leaf (kernels ~ N(0, 1/fan_in),
norm scales ~ 1 ± 0.1, BatchNorm variances in [0.5, 1.5], everything else
~ N(0, 0.1): the zero-initialized heads and camera layers then carry signal
too) and go to the port through ``weight_port.state_dict_from_flax``.
Inputs are numpy draws from a seed. Tolerances:

* rotations: values within 2e-6, gradients within 2e-5 (float32 Gram-Schmidt
  and quaternion branches; at the identity and at random rotations);
* backbones: max |Δ| ≤ 5e-5 × max(1, max |JAX|) over pooled, tokens and
  spatial (float32 sums over up to ~30 convolutions in a different order);
* heads, raw regressor outputs, the IEF history, the decode, the SMIL
  forward and the projections: within 2e-5 × max(1, max |JAX|);
* the losses: every component within 1e-5 relative, and their gradients
  with respect to the predictions within 2e-5 × max(1, max |JAX|); with
  the silhouette term (the port's raster on the CPU against the JAX
  package's), the term within 1e-2 relative and the gradients within
  5e-3 × max(1, max |JAX|), tests/test_torch_raster.py's gradient atol: the
  BCE's log(alpha + 1e-6) turns alpha differences of 1e-7 where the
  render is near 0 and the target 1 (the raster tests hold alpha to 1e-5)
  into a visible share of the term.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from smilify_tpu.core import rotations as jrot
from smilify_tpu.models import backbones as jbb
from smilify_tpu.models import multiview as jmv
from smilify_tpu.models import regressor as jreg
from smilify_tpu.models import transformer_decoder as jtd
from smilify_tpu.render.rasterizer import soft_silhouette as j_soft_silhouette
from smilify_tpu.train.multidevice import toy_model_spec as j_toy_spec

from smilify_tpu_torch.core import rotations as trot
from smilify_tpu_torch.core.spec import toy_model_spec as t_toy_spec
from smilify_tpu_torch.models import backbones as tbb
from smilify_tpu_torch.models import multiview as tmv
from smilify_tpu_torch.models import regressor as treg
from smilify_tpu_torch.models import transformer_decoder as ttd
from smilify_tpu_torch.models.weight_port import state_dict_from_flax
from smilify_tpu_torch.render.rasterizer import soft_silhouette as t_soft_silhouette

ROT_TOL, ROT_GRAD_TOL = 2e-6, 2e-5
BACKBONE_TOL = 5e-5
MODEL_TOL = 2e-5
LOSS_RTOL, LOSS_GRAD_TOL = 1e-5, 2e-5
SIL_RTOL, SIL_GRAD_TOL = 1e-2, 5e-3
J, NB = 6, 3


# ---------------------------------------------------------------------------
# helpers (also used by the other tests/test_torch_* files)
# ---------------------------------------------------------------------------


def random_variables(jmodule, *inputs, seed=0, **kw):
    """Seeded random values for every leaf of ``jmodule``'s variables (their
    shapes from ``jax.eval_shape`` of its init, which compiles nothing)."""
    shapes = unfreeze(jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *inputs, **kw)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name, shape = str(path[-1].key), s.shape
        if name == "kernel":
            fan_in = shape[0] if len(shape) == 3 else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def ported(tmodule, variables):
    tmodule.load_state_dict(state_dict_from_flax(variables, tmodule))
    return tmodule.eval()


def assert_close(got, want, tol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |Δ| {err:.3g} > {tol * scale:.3g}"


def specs(scaledirs=False, static=False):
    """The same toy spec in both packages (J=6, B=3), optionally with
    seeded scaledirs/transdirs or static joint locations."""
    js, ts = j_toy_spec(8, J, NB), t_toy_spec(8, J, NB, device="cpu")
    if scaledirs:
        rng = np.random.default_rng(5)
        sd = (0.1 * rng.standard_normal((NB, J, 3))).astype(np.float32)
        td = (0.1 * rng.standard_normal((NB, J, 3))).astype(np.float32)
        js = js.replace(scaledirs=jnp.asarray(sd), transdirs=jnp.asarray(td))
        ts = dataclasses.replace(ts, scaledirs=torch.from_numpy(sd), transdirs=torch.from_numpy(td))
    if static:
        js = js.replace(static_joint_locations=True)
        ts = dataclasses.replace(ts, static_joint_locations=True)
    return js, ts


def to_torch(tree, grad=False):
    return {k: torch.tensor(np.asarray(v), requires_grad=grad) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


def _aa(rng, n):
    return rng.standard_normal((n, 3)).astype(np.float32)


def _mats(rng, n):
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(_aa(rng, n))))


ROT_CASES = {
    "axis_angle_to_matrix": lambda rng, ident: np.zeros((4, 3), np.float32) if ident else _aa(rng, 8),
    "matrix_to_axis_angle": lambda rng, ident: np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    if ident else _mats(rng, 8),
    "matrix_to_quaternion": lambda rng, ident: np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    if ident else _mats(rng, 8),
    "quaternion_to_axis_angle": lambda rng, ident: np.tile(np.float32([1, 0, 0, 0]), (4, 1))
    if ident else np.asarray(jrot.matrix_to_quaternion(jnp.asarray(_mats(rng, 8)))),
    "matrix_to_rotation_6d": lambda rng, ident: _mats(rng, 8),
    "rotation_6d_to_matrix": lambda rng, ident: np.tile(np.float32([1, 0, 0, 0, 1, 0]), (4, 1))
    if ident else rng.standard_normal((8, 6)).astype(np.float32),
    "axis_angle_to_rotation_6d": lambda rng, ident: np.zeros((4, 3), np.float32) if ident
    else _aa(rng, 8),
    "rotation_6d_to_axis_angle": lambda rng, ident: np.tile(np.float32([1, 0, 0, 0, 1, 0]), (4, 1))
    if ident else rng.standard_normal((8, 6)).astype(np.float32),
    "robust_rotation_6d_to_matrix": lambda rng, ident: np.float32(
        [[1, 0, 0, 0, 1, 0], [0, 0, 0, 0.3, 1, 0], [1e-8, 0, 0, 0, 1, 0],
         [np.nan, 1, 0, 0, 0, 1]]) if ident else rng.standard_normal((8, 6)).astype(np.float32),
}


@pytest.mark.parametrize("case", ["identity", "random"])
@pytest.mark.parametrize("fn", sorted(ROT_CASES))
def test_rotation_matches_jax(fn, case):
    rng = np.random.default_rng(len(fn))
    x = ROT_CASES[fn](rng, case == "identity")
    jf, tf = getattr(jrot, fn), getattr(trot, fn)
    want = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = tf(xt)
    assert_close(got, want, ROT_TOL, fn)
    w = rng.standard_normal(want.shape).astype(np.float32)
    jgrad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jf(a) * w)))(jnp.asarray(x)))
    (got * torch.from_numpy(w)).sum().backward()
    assert np.isfinite(xt.grad.numpy()).all(), f"{fn}: non-finite gradient"
    assert_close(xt.grad, jgrad, ROT_GRAD_TOL, f"{fn} gradient")


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

F32 = jnp.float32
BACKBONES = {
    "resnet_bn": (lambda: jbb.ResNet([1, 1, 1, 1], dtype=F32), lambda: tbb.ResNet([1, 1, 1, 1]), 64),
    "resnet_gn": (lambda: jbb.ResNet([1, 1, 1, 1], dtype=F32, norm="group"),
                  lambda: tbb.ResNet([1, 1, 1, 1], norm="group"), 64),
    "vit": (lambda: jbb.ViT(2, 64, 4, dtype=F32), lambda: tbb.ViT(2, 64, 4, img_size=64), 64),
    "vit_same_pad": (lambda: jbb.ViT(1, 32, 4, dtype=F32), lambda: tbb.ViT(1, 32, 4, img_size=40), 40),
    "unet_micro": (lambda: jbb.UNet(widths=(8, 16, 32), out_dim=32, dtype=F32),
                   lambda: tbb.UNet(widths=(8, 16, 32), out_dim=32), 32),
    "unet_small": (lambda: jbb.UNet(widths=(32, 64, 128, 256), out_dim=256, dtype=F32),
                   lambda: tbb.UNet(widths=(32, 64, 128, 256), out_dim=256), 32),
    "unet_resnet34": (lambda: jbb.UNetResNet(dtype=F32), lambda: tbb.UNetResNet(), 32),
}


def check_backbone(jmod, tmod, size, seed=0):
    x = np.random.default_rng(seed).random((2, size, size, 3), dtype=np.float32)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = ported(tmod, v)(torch.from_numpy(x))
    for name in ("pooled", "tokens", "spatial"):
        assert_close(getattr(got, name), getattr(want, name), BACKBONE_TOL, name)
        assert getattr(got, name).dtype == torch.float32


@pytest.mark.parametrize("family", sorted(BACKBONES))
def test_backbone_matches_jax(family):
    jmake, tmake, size = BACKBONES[family]
    check_backbone(jmake(), tmake(), size)


def test_create_backbone_names_and_dims():
    assert sorted(tbb.BACKBONES) == sorted(jbb.BACKBONES)
    for name in ("unet_micro", "unet_small", "resnet50"):
        module, dim = tbb.create_backbone(name)
        assert dim == jbb.BACKBONES[name]()[1]
        assert type(module).__name__ == type(jbb.BACKBONES[name]()[0]).__name__


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

GROUPS = (("global_rot", 6), ("joint_rot", 6 * (J - 1)), ("betas", NB), ("trans", 3), ("fov", 1),
          ("cam_rot", 9), ("cam_trans", 3))


def test_decoder_layer_matches_jax():
    rng = np.random.default_rng(1)
    q, mem = rng.standard_normal((2, 1, 32), dtype=np.float32), rng.standard_normal((2, 7, 32), dtype=np.float32)
    jm = jtd.DecoderLayer(32, 4, mlp_dim=48)
    v = random_variables(jm, jnp.asarray(q), jnp.asarray(mem))
    want = jax.jit(jm.apply)(v, jnp.asarray(q), jnp.asarray(mem))
    with torch.no_grad():
        got = ported(ttd.DecoderLayer(32, 4, mlp_dim=48), v)(torch.from_numpy(q), torch.from_numpy(mem))
    assert_close(got, want, MODEL_TOL, "DecoderLayer")


@pytest.mark.parametrize("head", ["ief", "mlp"])
def test_heads_match_jax(head):
    rng = np.random.default_rng(2)
    tokens = rng.standard_normal((2, 9, 24), dtype=np.float32)
    pooled = rng.standard_normal((2, 24), dtype=np.float32)
    if head == "ief":
        jm = jtd.SMILTransformerDecoderHead(GROUPS, dim=32, depth=2, num_heads=4, ief_iters=3, n_pose=J - 1)
        tm = ttd.SMILTransformerDecoderHead(GROUPS, token_dim=24, dim=32, depth=2, num_heads=4,
                                            ief_iters=3, n_pose=J - 1)
        x = tokens
    else:
        jm = jtd.MLPHead(GROUPS, hidden=32, n_pose=J - 1)
        tm = ttd.MLPHead(GROUPS, in_dim=24, hidden=32, n_pose=J - 1)
        x = pooled
    v = random_variables(jm, jnp.asarray(x))
    want, jhist = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got, thist = ported(tm, v)(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], MODEL_TOL, k)
    assert len(thist) == len(jhist)
    for i, (a, b) in enumerate(zip(thist, jhist)):
        assert_close(a, b, MODEL_TOL, f"history {i}")


def test_fresh_heads_start_at_the_identity_estimate():
    """Zero-initialized delta heads: a fresh IEF head returns its initial
    estimate, the 6D identity and the default camera."""
    tm = ttd.SMILTransformerDecoderHead(GROUPS, token_dim=8, dim=16, depth=1, num_heads=2, n_pose=J - 1)
    with torch.no_grad():
        out, _ = tm(torch.randn(2, 5, 8))
    np.testing.assert_array_equal(out["global_rot"].numpy(), np.float32([[1, 0, 0, 0, 1, 0]] * 2))
    np.testing.assert_array_equal(out["cam_trans"].numpy(), np.float32([[0, 0, 2.7]] * 2))
    np.testing.assert_array_equal(out["fov"].numpy(), np.float32([[60.0]] * 2))


# ---------------------------------------------------------------------------
# the single-view regressor: raw, decode, forward, projection, loss
# ---------------------------------------------------------------------------

REG_KW = dict(backbone="unet_micro", n_pose=J - 1, n_betas=NB, n_joints=J, decoder_dim=32,
              decoder_depth=2, decoder_heads=4, ief_iters=2, mlp_hidden=32)


@pytest.mark.parametrize("head", ["transformer", "mlp"])
def test_regressor_raw_matches_jax(head):
    x = np.random.default_rng(3).random((2, 32, 32, 3), dtype=np.float32)
    jm = jreg.SMILRegressor(jreg.RegressorConfig(head_type=head, compute_dtype=F32, **REG_KW))
    tm = treg.SMILRegressor(treg.RegressorConfig(head_type=head, compute_dtype=torch.float32, **REG_KW),
                            img_size=32)
    v = random_variables(jm, jnp.asarray(x))
    want, jhist = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got, thist = ported(tm, v)(torch.from_numpy(x))
    for k in want:
        assert_close(got[k], want[k], MODEL_TOL, k)
    for a, b in zip(thist, jhist):
        assert_close(a, b, MODEL_TOL, "history")
    assert len(thist) == len(jhist)


DECODE_MODES = {
    "6d": dict(),
    "axis_angle": dict(rotation_representation="axis_angle"),
    "separate_pca": dict(scale_trans_mode="separate"),
    "separate_per_joint": dict(scale_trans_mode="separate", use_pca_scale_trans=False,
                               trans_scale_factor=0.01),
    "entangled": dict(scale_trans_mode="entangled_with_betas"),
    "mesh_scale_log": dict(allow_mesh_scaling=True, init_mesh_scale=1.5),
    "mesh_scale_linear": dict(allow_mesh_scaling=True, use_log_mesh_scale=False),
}


def _raw(cfg, rng, B=3):
    raw = {n: (rng.standard_normal((B, d)) * 0.5).astype(np.float32) for n, d in cfg.group_dims()}
    raw["fov"] += 60.0
    return raw


@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
def test_decode_matches_jax(mode):
    kw = dict(n_pose=J - 1, n_betas=NB, n_joints=J, **DECODE_MODES[mode])
    jcfg, tcfg = jreg.RegressorConfig(**kw), treg.RegressorConfig(**kw)
    js, ts = specs(scaledirs=True)
    raw = _raw(jcfg, np.random.default_rng(4))
    if tcfg.rotation_representation == "6d":
        raw["global_rot"][0] = [1, 0, 0, 0, 1, 0]  # the identity, the heads' start
    want = jax.jit(lambda r: jreg.decode_predictions(jcfg, r, js))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    got = treg.decode_predictions(tcfg, to_torch(raw), ts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], MODEL_TOL, k)


def _preds(rng, B=2, P=J - 1):
    return {
        "global_rot": (rng.standard_normal((B, 3)) * 0.2).astype(np.float32),
        "joint_rot": (rng.standard_normal((B, P, 3)) * 0.1).astype(np.float32),
        "betas": (rng.standard_normal((B, NB)) * 0.3).astype(np.float32),
        "trans": (rng.standard_normal((B, 3)) * 0.05).astype(np.float32),
        "fov": (60 + rng.standard_normal(B) * 3).astype(np.float32),
        "cam_rot": np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(
            (np.float32([0, np.pi, 0]) + 0.1 * rng.standard_normal((B, 3))).astype(np.float32)))),
        "cam_trans": (np.float32([0, 0, 2.7]) + 0.1 * rng.standard_normal((B, 3))).astype(np.float32),
    }


FORWARD_CASES = {"plain": {}, "ue": {"ue": True}, "mesh_scale": {"mesh_scale": True},
                 "static_joints": {"static": True}, "limb_scales": {"limbs": True}}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_model_and_projection_match_jax(case):
    c = FORWARD_CASES[case]
    rng = np.random.default_rng(6)
    preds = _preds(rng)
    if c.get("mesh_scale"):
        preds["mesh_scale"] = np.float32([0.8, 1.3])
    if c.get("limbs"):
        preds["log_beta_scales"] = (0.1 * rng.standard_normal((2, J, 3))).astype(np.float32)
        preds["betas_trans"] = (0.05 * rng.standard_normal((2, J, 3))).astype(np.float32)
    js, ts = specs(static=c.get("static", False))
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jv, jj = jax.jit(lambda p: jreg.forward_model(js, p, use_ue_scaling=c.get("ue", False)))(jp)
    tp = to_torch(preds)
    tv, tj = treg.forward_model(ts, tp, use_ue_scaling=c.get("ue", False))
    assert_close(tv, jv, MODEL_TOL, "verts")
    assert_close(tj, jj, MODEL_TOL, "joints")
    want = jax.jit(lambda p, j: jreg.project_to_camera(p, j, (48, 64)))(jp, jj)
    assert_close(treg.project_to_camera(tp, tj, (48, 64)), want, MODEL_TOL, "projection")


def _render_fns(size):
    def jfn(v, cam):
        pv = cam.world_to_view(v)
        ndc = cam.view_to_ndc(pv)
        return j_soft_silhouette(jnp.concatenate([ndc[:, :2], pv[:, 2:3]], 1), jfaces, size,
                                 znear=cam.znear)

    def tfn(v, cam):
        pv = cam.world_to_view(v)
        ndc = cam.view_to_ndc(pv)
        return t_soft_silhouette(torch.cat([ndc[:, :2], pv[:, 2:3]], 1), tfaces, size, znear=cam.znear)

    js, ts = specs()
    jfaces, tfaces = js.faces, ts.faces
    return jfn, tfn


@pytest.mark.parametrize("variant", ["per_joint_visibility", "masked_mse"])
def test_batch_loss_and_gradients_match_jax(variant):
    rng = np.random.default_rng(7)
    B, H = 3, 32
    preds = _preds(rng, B)
    preds["log_beta_scales"] = (0.1 * rng.standard_normal((B, J, 3))).astype(np.float32)
    preds["betas_trans"] = (0.05 * rng.standard_normal((B, J, 3))).astype(np.float32)
    tgt = _preds(np.random.default_rng(8), B)
    tgt.update(log_beta_scales=np.zeros((B, J, 3), np.float32),
               betas_trans=np.zeros((B, J, 3), np.float32),
               keypoints_2d=rng.random((B, J, 2), dtype=np.float32),
               keypoints_3d=(0.3 * rng.standard_normal((B, J, 3))).astype(np.float32),
               silhouette=(rng.random((B, H, H)) > 0.7).astype(np.float32))
    vis = (rng.random((B, J)) > 0.2).astype(np.float32)
    vis[0] = 1.0
    if variant == "per_joint_visibility":
        tgt["kp_visibility"] = vis            # K = P + 1: the rotation-matrix branch
    avail = {"pose": np.float32([1, 1, 0]), "camera": np.float32([1, 0, 1]),
             "betas": np.float32([0, 1, 1])}
    importance = np.float32([1, 2, 1, 0, 1, 1])
    jfn, tfn = _render_fns((H, H))
    cfg_kw = dict(n_pose=J - 1, n_betas=NB, n_joints=J)
    js, ts = specs()
    jt, ja = ({k: jnp.asarray(v) for k, v in d.items()} for d in (tgt, avail))
    # the loss without the silhouette term at the tight tolerances, then with it
    for sil, rtol, gtol in ((0.0, LOSS_RTOL, LOSS_GRAD_TOL), (0.5, SIL_RTOL, SIL_GRAD_TOL)):
        weights = {k: 1.0 for k in jreg.DEFAULT_LOSS_WEIGHTS}
        weights["silhouette"] = sil

        def jloss(p):
            return jreg.compute_batch_loss(js, jreg.RegressorConfig(**cfg_kw), p, jt, weights, (H, H),
                                           ja, jnp.asarray(importance), render_silhouette_fn=jfn)

        (jtotal, jobjs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in preds.items()})
        tp = to_torch(preds, grad=True)
        ttotal, tobjs = treg.compute_batch_loss(
            ts, treg.RegressorConfig(**cfg_kw), tp, to_torch(tgt), weights, (H, H), to_torch(avail),
            torch.from_numpy(importance), render_silhouette_fn=tfn)
        assert sorted(tobjs) == sorted(jobjs) and "keypoint_2d" in tobjs
        assert ("silhouette" in tobjs) == (sil > 0)
        for k in jobjs:
            np.testing.assert_allclose(float(tobjs[k].detach()), float(jobjs[k]),
                                       rtol=rtol if k == "silhouette" else LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), rtol=rtol)
        ttotal.backward()
        for k in preds:
            assert_close(tp[k].grad, jgrads[k], gtol, f"d total / d {k} (silhouette weight {sil})")


def test_sample_validity_matches_jax():
    rng = np.random.default_rng(9)
    vis = (rng.random((5, 8)) > 0.4).astype(np.float32)
    sil = (rng.random((5, 16, 16)) > rng.random((5, 1, 1)) * 1.1).astype(np.float32)
    want = jreg.compute_sample_validity(jnp.asarray(vis), jnp.asarray(sil))
    got = treg.compute_sample_validity(torch.from_numpy(vis), torch.from_numpy(sil))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the multi-view regressor and its loss
# ---------------------------------------------------------------------------

MV_KW = dict(REG_KW, max_views=3, fusion_heads=4, fusion_layers=2, num_canonical_cameras=5)


@pytest.mark.parametrize("chunk", [None, 4])
def test_multiview_matches_jax_with_masked_views(chunk):
    rng = np.random.default_rng(10)
    x = rng.random((3, 3, 32, 32, 3), dtype=np.float32)
    vm = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 0]], bool)   # full, partly, fully masked
    cid = np.array([[0, 1, 2], [3, 4, 9], [2, 0, 1]], np.int32)  # 9 is clipped to 4
    jm = jmv.MultiViewSMILRegressor(jmv.MultiViewConfig(compute_dtype=F32, backbone_chunk_size=chunk,
                                                        **MV_KW))
    tcfg = tmv.MultiViewConfig(compute_dtype=torch.float32, backbone_chunk_size=chunk, **MV_KW)
    v = random_variables(jm, jnp.asarray(x), jnp.asarray(vm), jnp.asarray(cid))
    want, jhist = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(vm), jnp.asarray(cid))
    with torch.no_grad():
        got, thist = ported(tmv.MultiViewSMILRegressor(tcfg, img_size=32), v)(
            torch.from_numpy(x), torch.from_numpy(vm), torch.from_numpy(cid))
    for k in want:
        assert_close(got[k], want[k], MODEL_TOL, k)
        assert torch.isfinite(got[k][2]).all(), f"{k}: the fully masked sample is not finite"
    for a, b in zip(thist, jhist):
        assert_close(a, b, MODEL_TOL, "history")
    js, ts = specs()
    jd = jax.jit(lambda r: jmv.decode_multiview_predictions(jm.config, r, js))(want)
    td = tmv.decode_multiview_predictions(tcfg, got, ts)
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert_close(td[k], jd[k], MODEL_TOL, f"decoded {k}")


def test_multiview_loss_and_gradients_match_jax():
    rng = np.random.default_rng(11)
    B, V, H = 2, 3, 48
    p = _preds(rng, B)
    preds = {k: p[k] for k in ("global_rot", "joint_rot", "betas", "trans")}
    preds["view_fov"] = (60 + 3 * rng.standard_normal((B, V))).astype(np.float32)
    preds["view_cam_rot"] = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(
        (np.float32([0, np.pi, 0]) + 0.3 * rng.standard_normal((B, V, 3))).astype(np.float32))))
    preds["view_cam_trans"] = (np.float32([0, 0, 2.7]) + 0.1 * rng.standard_normal((B, V, 3))).astype(np.float32)
    tgt = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32) for k, v in preds.items()}
    tgt.update(keypoints_2d=(0.5 + 0.1 * rng.standard_normal((B, V, J, 2))).astype(np.float32),
               kp_visibility=(rng.random((B, V, J)) > 0.2).astype(np.float32),
               keypoints_3d=(0.3 * rng.standard_normal((B, J, 3))).astype(np.float32))
    vm = np.array([[1, 1, 1], [1, 0, 1]], bool)
    importance = np.float32([1, 2, 1, 0, 1, 1])
    js, ts = specs()
    jcfg, tcfg = jmv.MultiViewConfig(n_pose=J - 1, n_betas=NB, n_joints=J), \
        tmv.MultiViewConfig(n_pose=J - 1, n_betas=NB, n_joints=J)
    jt = {k: jnp.asarray(v) for k, v in tgt.items()}

    def jloss(pp):
        return jmv.compute_multiview_batch_loss(js, jcfg, pp, jt, jnp.asarray(vm), None, (H, H),
                                                jnp.asarray(importance))

    (jtotal, jobjs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = to_torch(preds, grad=True)
    ttotal, tobjs = tmv.compute_multiview_batch_loss(ts, tcfg, tp, to_torch(tgt), torch.from_numpy(vm),
                                                     None, (H, H), torch.from_numpy(importance))
    assert sorted(tobjs) == sorted(jobjs) and "triangulation_consistency" in tobjs
    for k in jobjs:
        np.testing.assert_allclose(float(tobjs[k].detach()), float(jobjs[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    ttotal.backward()
    for k in preds:
        assert_close(tp[k].grad, jgrads[k], LOSS_GRAD_TOL, f"d total / d {k}")


def test_view_projection_matrices_match_jax():
    rng = np.random.default_rng(12)
    preds = {"view_fov": (60 + 5 * rng.standard_normal((2, 4))).astype(np.float32),
             "view_cam_rot": _mats(rng, 8).reshape(2, 4, 3, 3),
             "view_cam_trans": rng.standard_normal((2, 4, 3)).astype(np.float32)}
    want = jax.jit(jmv.view_projection_matrices)({k: jnp.asarray(v) for k, v in preds.items()})
    assert_close(tmv.view_projection_matrices(to_torch(preds)), want, 1e-6, "P")
