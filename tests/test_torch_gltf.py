"""glTF export in the port, held to the JAX package on the CPU.

Both packages' ``export_animation_gltf`` run on the same toy specs (the
port's carried across from the JAX package's with ``spec_from_numpy``) and
the same animations made from a numpy seed; the ``.glb`` files must hold the
same JSON but for ``asset.generator`` and the same binary chunk byte for
byte, in hierarchy mode (rotations and root motion; per-joint translations),
flat mode (per-joint scales), with morph targets (a static-joint spec with
per-frame betas), with the averaged-betas fallback and with pose correctives
(each warning as the JAX package warns). The specs are
``dataclasses.replace`` of the toy (8, 6, 3) spec: each vertex skinned to
its 4 heaviest joints (glTF's 4 influences), zero ``posedirs`` (glTF cannot
carry pose correctives, as ``tests/test_gltf_export.py:115-117`` assumes),
and a static-joint one with ``scaledirs``/``transdirs``.
Hierarchy mode still refuses per-joint scales, and the CLI runs in-process
on both packages (an animation and ``--rest-pose``). The port's file is
also re-evaluated with ``tests/test_gltf_export.py``'s numpy glTF evaluator
against the port's ``smil_forward`` within that file's TOL = 3e-4.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec
from smilify_tpu.utils import gltf_export as jgltf

from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.utils import gltf_export as tgltf
from tests.test_gltf_export import TOL, eval_glb_frame
from tests.test_torch_authoring import carry

F = 3


def _four_influences(js):
    """``js`` with each vertex skinned to its 4 heaviest joints (glTF carries
    4 influences a vertex), renormalized."""
    w = np.asarray(js.weights, np.float64)
    w = np.where(w >= np.sort(w, axis=1)[:, -4:-3], w, 0.0)
    return dataclasses.replace(js, weights=jnp.asarray((w / w.sum(1, keepdims=True))
                                                       .astype(np.float32)))


def _stick():
    return _four_influences(jax_toy_spec(8, 6, 3))


def _static():
    """A static-joint toy spec with entangled scale and translation dirs."""
    js = _four_influences(jax_toy_spec(8, 6, 3, seed=1))
    rng = np.random.RandomState(7)
    B, J = js.n_betas, js.n_joints
    return dataclasses.replace(
        js, static_joint_locations=True,
        scaledirs=jnp.asarray(rng.randn(B, J, 3).astype(np.float32) * 0.05),
        transdirs=jnp.asarray(rng.randn(B, J, 3).astype(np.float32) * 0.01))


def _posed():
    js = _stick()
    rng = np.random.RandomState(8)
    return dataclasses.replace(js, posedirs=jnp.asarray(
        rng.randn(*js.posedirs.shape).astype(np.float32) * 1e-3))


def _anim(spec, scale_mag=0.0, jtrans_mag=0.0, betas_pf=False, seed=11):
    rng = np.random.default_rng(seed)
    J, B = spec.n_joints, spec.n_betas
    data = {"poses": rng.normal(0, 0.15, (F, 3 + 3 * (J - 1))).astype(np.float32),
            "trans": rng.normal(0, 0.3, (F, 3)).astype(np.float32),
            "betas": rng.normal(0, 0.3, B).astype(np.float32),
            "mocap_framerate": np.float32(24.0)}
    if scale_mag:
        ls = rng.normal(0, scale_mag, (F, J, 3)).astype(np.float32)
        ls[:, 0] = 0.0
        data["log_beta_scales"] = ls
    if jtrans_mag:
        data["betas_trans"] = rng.normal(0, jtrans_mag, (F, J, 3)).astype(np.float32)
    if betas_pf:
        data["betas_per_frame"] = rng.normal(0, 0.3, (F, B)).astype(np.float32)
    return data


# case → (JAX spec, animation kwargs, export kwargs, mode, warning expected)
CASES = {
    "hierarchy": (_stick, {}, {}, "hierarchy", None),
    "hierarchy_joint_trans": (_static, {"jtrans_mag": 0.02}, {}, "hierarchy", None),
    "flat_scales": (_static, {"scale_mag": 0.1, "jtrans_mag": 0.01}, {}, "flat", None),
    "morph_targets": (_static, {"betas_pf": True}, {}, "hierarchy", None),
    "static_shape_forced": (_static, {"betas_pf": True}, {"static_shape": True}, "hierarchy", None),
    "averaged_betas": (_stick, {"betas_pf": True}, {}, "hierarchy", "clip-averaged"),
    "flat_forced": (_stick, {}, {"mode": "flat", "fps": 12.0}, "flat", None),
    "pose_correctives": (_posed, {}, {}, "hierarchy", "pose correctives"),
    "dense_weights": (lambda: jax_toy_spec(8, 6, 3), {}, {}, "hierarchy", "4 influences"),
}


def _export(module, spec, data, path, warn, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = module.export_animation_gltf(spec, data, path, sidecar={"schema_version": "1"}, **kw)
    msgs = [str(w.message) for w in caught]
    if warn is not None:
        assert any(warn in m for m in msgs), msgs
    return out, msgs


def _same_glb(tpath, jpath):
    tg, tb = tgltf.load_glb(tpath)
    jg, jb = jgltf.load_glb(jpath)
    assert tg["asset"].pop("generator") == "smilify_tpu_torch.utils.gltf_export"
    assert jg["asset"].pop("generator") == "smilify_tpu.utils.gltf_export"
    assert tg == jg
    assert tb == jb
    return tg, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_glb_matches_jax(tmp_path, case):
    make, anim_kw, kw, mode, warn = CASES[case]
    js = make()
    ts = carry(js)
    data = _anim(js, **anim_kw)
    jpath, jmsgs = _export(jgltf, js, data, str(tmp_path / "j.glb"), warn, **kw)
    tpath, tmsgs = _export(tgltf, ts, data, str(tmp_path / "t.glb"), warn, **kw)
    assert tmsgs == jmsgs
    gltf, blob = _same_glb(tpath, jpath)
    assert gltf["extras"]["smilify_tpu"]["mode"] == mode
    assert gltf["extras"]["smilify_tpu"]["animate_shape"] == (
        case == "morph_targets")

    if case in ("hierarchy", "hierarchy_joint_trans", "flat_scales", "morph_targets"):
        # the port's file against the port's forward
        J = ts.n_joints
        theta = np.concatenate([data["poses"][:, :3].reshape(F, 1, 3),
                                data["poses"][:, 3:].reshape(F, J - 1, 3)], axis=1)
        betas = data["betas_per_frame"] if "betas_per_frame" in data else np.broadcast_to(
            data["betas"], (F, ts.n_betas))
        opt = {k: torch.from_numpy(data[src]) for k, src in (
            ("log_scales", "log_beta_scales"), ("joint_trans", "betas_trans")) if src in data}
        want = smil_forward(ts, torch.from_numpy(np.ascontiguousarray(betas)),
                            torch.from_numpy(theta), trans=torch.from_numpy(data["trans"]),
                            **opt).verts.numpy()
        for f in range(F):
            assert np.abs(eval_glb_frame(gltf, blob, f) - want[f]).max() < TOL


def test_hierarchy_mode_refuses_scales(tmp_path):
    ts = carry(_static())
    with pytest.raises(ValueError, match="scale-cancel"):
        tgltf.export_animation_gltf(ts, _anim(ts, scale_mag=0.1), str(tmp_path / "x.glb"),
                                    mode="hierarchy")
    # and the flat export of the same clip is exact (no shear)
    out = tgltf.export_animation_gltf(ts, _anim(ts, scale_mag=0.1), str(tmp_path / "x.glb"))
    assert tgltf.load_glb(out)[0]["extras"]["smilify_tpu"]["max_shear_residual"] < 1e-6


def test_read_accessor_matches_jax(tmp_path):
    js = _static()
    path = jgltf.export_animation_gltf(js, _anim(js, betas_pf=True), str(tmp_path / "m.glb"))
    gltf, blob = jgltf.load_glb(path)
    for i in range(len(gltf["accessors"])):
        np.testing.assert_array_equal(tgltf.read_accessor(gltf, blob, i),
                                      jgltf.read_accessor(gltf, blob, i))
    with pytest.raises(ValueError, match="not a glTF"):
        (tmp_path / "bad.glb").write_bytes(b"\0" * 32)
        tgltf.load_glb(str(tmp_path / "bad.glb"))


@pytest.mark.parametrize("rest_pose", [False, True])
def test_cli_matches_jax(tmp_path, rest_pose):
    from smilify_tpu.cli.export_gltf import main as j_export_gltf

    from smilify_tpu_torch.cli.export_gltf import main as t_export_gltf
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
    from smilify_tpu_torch.utils.animation_export import AnimationRecorder

    spec = toy_model_spec(8, 6, 3, device="cpu")
    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), spec)
    if rest_pose:
        args = ["--model", pkl, "--rest-pose", "--betas", "0.5,-0.25,1.0"]
    else:
        rng = np.random.default_rng(3)
        rec = AnimationRecorder(model_name="toy", fps=12.0)
        for _ in range(F):
            rec.add_frame(rng.normal(0, 0.1, 3), rng.normal(0, 0.1, (spec.n_joints - 1, 3)),
                          rng.normal(0, 0.1, 3), betas=rng.normal(0, 0.2, 3).astype(np.float32))
        args = ["--model", pkl, "--animation", rec.export(str(tmp_path / "clip")), "--mode", "flat"]
    j_export_gltf(args + ["--out", str(tmp_path / "j.glb")])
    out = t_export_gltf(args + ["--out", str(tmp_path / "t.glb"), "--device", "cpu"])
    gltf, blob = _same_glb(out, str(tmp_path / "j.glb"))
    assert gltf["extras"]["smilify_tpu"]["num_frames"] == (1 if rest_pose else F)
