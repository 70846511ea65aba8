"""Parity of the port's fitter CLIs and their modules (PNG codec and resize,
joint markers and collage, loaders, Phong render, priors, the model pickle)
with the JAX package and the libraries it calls (imageio, OpenCV) on the CPU.

Inputs are written by the test from a numpy seed or by
``smilify_tpu_torch.tools.synthetic_data`` (a toy (8, 6, 3) spec at 64²).
Tolerances: images, masks, markers, topology and loaders exactly; resized RGB
within 1e-5 of ``cv2.resize``; Phong face ids on ≥ 99.9% of pixels and
shading within 1e-5 where they agree; priors within 1e-5; the CLIs' final
parameters and PLY vertices within 1e-4 and collages at most one level apart.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os
import pickle
import struct
import zlib

import cv2
import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from smilify_tpu.core.spec import load_model_spec as jax_load_model_spec
from smilify_tpu.data import loaders as jload
from smilify_tpu.fitter import priors as jpri
from smilify_tpu.render import phong as jphong
from smilify_tpu.utils import authoring as jauth
from smilify_tpu.utils import visualization as jvis

from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
from smilify_tpu_torch.data import loaders as tload
from smilify_tpu_torch.fitter import priors as tpri
from smilify_tpu_torch.render import phong as tphong
from smilify_tpu_torch.render.cameras import default_camera
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
from smilify_tpu_torch.utils import authoring as tauth
from smilify_tpu_torch.utils import image_io
from smilify_tpu_torch.utils import visualization as tvis
from smilify_tpu_torch.utils.export import load_fitter_checkpoint

SIZE = 64


# ---------------------------------------------------------------------------
# PNG and resize
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(img, filters):
    """An 8-bit PNG of ``img`` whose row y uses filter ``filters[y % len(filters)]``."""
    img = img if img.ndim == 3 else img[..., None]
    H, W, C = img.shape
    rows = img.reshape(H, W * C).astype(np.int64)
    out, prior = [], np.zeros(W * C, np.int64)
    for y in range(H):
        row, f = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(C, np.int64), row[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prior[:-C]])
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trips_against_imageio(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (13, 17, channels)).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        path = tmp_path / f"f{filters[-1]}_{len(filters)}.png"
        path.write_bytes(_encode_png(img, filters))
        np.testing.assert_array_equal(imageio.imread(path), img)
        np.testing.assert_array_equal(image_io.read_png(path), img)
    mine, theirs = tmp_path / "mine.png", tmp_path / "theirs.png"
    image_io.write_png(mine, img)
    np.testing.assert_array_equal(imageio.imread(mine), img)
    imageio.imwrite(theirs, img)
    np.testing.assert_array_equal(image_io.read_png(theirs), img)
    np.testing.assert_array_equal(image_io.read_image(theirs), img)


def test_png_palette_and_other_formats(tmp_path):
    rng = np.random.RandomState(5)
    pal = Image.fromarray(rng.randint(0, 4, (9, 11)).astype(np.uint8), mode="P")
    pal.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 10, 20, 30] + [0] * 756)
    pal.save(tmp_path / "pal.png")
    np.testing.assert_array_equal(image_io.read_png(tmp_path / "pal.png"),
                                  imageio.imread(tmp_path / "pal.png"))
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    imageio.imwrite(tmp_path / "x.jpg", rgb)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "x.jpg"),
                                  imageio.imread(tmp_path / "x.jpg"))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(tmp_path / "x.jpg")
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_png(tmp_path / "f.png", rgb.astype(np.float32))


@pytest.mark.parametrize("shape", [(40, 52), (40, 52, 3), (7, 9, 3)])
@pytest.mark.parametrize("size", [(32, 32), (64, 80), (13, 29)])
def test_resize_matches_cv2(shape, size):
    img = np.random.RandomState(len(shape)).rand(*shape)
    sil = (img[..., 0] if img.ndim == 3 else img) > 0.5
    for arr, mode, flag in ((sil.astype(np.float64), "nearest", cv2.INTER_NEAREST),
                            (img, "linear", cv2.INTER_LINEAR),
                            (img.astype(np.float32), "linear", cv2.INTER_LINEAR)):
        want = cv2.resize(arr, size[::-1], interpolation=flag)
        got = image_io.resize(arr, size, mode)
        assert got.dtype == want.dtype and got.shape == want.shape
        if mode == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# markers, collage, Phong
# ---------------------------------------------------------------------------


def _joints():
    """(row, col) joints: inside, on every border, near the corners, off the image."""
    return np.array([[10.4, 20.7], [0, 5], [63, 40], [30, 0], [31, 63], [1, 1], [62.9, 62.2],
                     [-1, 10], [10, 64], [70, -3], [2, 61]], np.float32)


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_draw_joints_and_fit_collage_equal_cv2(dtype):
    rng = np.random.RandomState(0)
    img = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    img = (img * 255).astype(np.uint8) if dtype == "uint8" else img
    j = _joints()
    vis = np.ones(len(j), np.float32)
    vis[3] = 0
    for size in (6, 4, 7):
        np.testing.assert_array_equal(tvis.draw_joints(img, j, vis, marker_size=size),
                                      jvis.draw_joints(img, j, vis, marker_size=size))
    np.testing.assert_array_equal(tvis.draw_joints(img, j), jvis.draw_joints(img, j))
    if dtype == "float":
        args = (img, rng.rand(SIZE, SIZE, 3).astype(np.float32), rng.rand(SIZE, SIZE) > 0.5,
                rng.rand(SIZE, SIZE).astype(np.float32), j, j[::-1] + 0.5, vis)
        np.testing.assert_array_equal(tvis.fit_collage(*args), jvis.fit_collage(*args))
        rev = rng.rand(SIZE, SIZE, 3).astype(np.float32)
        np.testing.assert_array_equal(tvis.fit_collage(*args, rev_rendered=rev),
                                      jvis.fit_collage(*args, rev_rendered=rev))
    assert tvis.rainbow_colors(5) == jvis.rainbow_colors(5)
    pred, gt = rng.rand(2, 7, 2) * 10
    assert tvis.pck(pred, gt, vis[:7], 4.0) == jvis.pck(pred, gt, vis[:7], 4.0)


@pytest.fixture(scope="module")
def toy():
    return toy_model_spec(8, 6, 3, device="cpu")


def _posed_view(spec, seed=0):
    from smilify_tpu_torch.core.lbs import smil_forward
    from smilify_tpu_torch.fitter.fitter import synthetic_poses

    betas, theta, trans = (torch.from_numpy(a) for a in synthetic_poses(spec, 1, seed))
    verts = (smil_forward(spec, betas, theta).verts + trans[:, None])[0]
    cam = default_camera(device="cpu")
    pv = cam.world_to_view(verts)
    ndc = torch.cat([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], dim=1)
    return verts, pv, ndc


def test_render_phong_matches_jax(toy):
    verts, pv, ndc = _posed_view(toy)
    faces = toy.faces
    fid, bary, zbuf = tphong.rasterize_hard(ndc, faces, (SIZE, SIZE), face_chunk=13)
    jfid, jbary, jzbuf = (np.asarray(a) for a in jphong.rasterize_hard(
        jnp.asarray(ndc.numpy()), jnp.asarray(faces.numpy().astype(np.int32)), (SIZE, SIZE)))
    same = fid.numpy() == jfid
    assert same.mean() >= 0.999 and (jfid >= 0).mean() > 0.05
    np.testing.assert_allclose(bary.numpy()[same], jbary[same], atol=1e-5)
    np.testing.assert_allclose(zbuf.numpy()[same & (jfid >= 0)], jzbuf[same & (jfid >= 0)],
                               atol=1e-5)
    img = tphong.render_phong(verts, pv, ndc, faces, (SIZE, SIZE)).numpy()
    jimg = np.asarray(jphong.render_phong(*(jnp.asarray(a.numpy()) for a in (verts, pv, ndc)),
                                          jnp.asarray(faces.numpy().astype(np.int32)),
                                          (SIZE, SIZE)))
    np.testing.assert_allclose(img[same], jimg[same], atol=1e-5)
    # the chunk only bounds memory: the same ids at any chunk size
    np.testing.assert_array_equal(
        tphong.rasterize_hard(ndc, faces, (SIZE, SIZE), face_chunk=1000)[0].numpy(), fid.numpy())


# ---------------------------------------------------------------------------
# priors, model pickle
# ---------------------------------------------------------------------------


def test_walking_and_unity_priors_match_jax(tmp_path, toy):
    rng = np.random.RandomState(1)
    n = toy.n_betas + 7
    np.savez(tmp_path / "unity.npz", mean=rng.randn(n), cov=np.eye(n) * 0.5 + 0.01)
    J = toy.n_joints
    with open(tmp_path / "walking.pkl", "wb") as f:
        pickle.dump({"mean_pose": rng.randn(3 * J - 3), "pic": np.eye(3 * J) + 0.1}, f, protocol=2)
    theta = rng.uniform(-0.3, 0.3, (2, J, 3)).astype(np.float32)
    jp = jpri.walking_pose_prior(str(tmp_path / "walking.pkl"))
    tp = tpri.walking_pose_prior(str(tmp_path / "walking.pkl"))
    np.testing.assert_allclose(tp(torch.from_numpy(theta)).numpy(), np.asarray(jp(jnp.asarray(theta))),
                               rtol=1e-5, atol=1e-5)
    betas = rng.randn(3, n - 1).astype(np.float32)
    js = jpri.unity_shape_prior(str(tmp_path / "unity.npz"), n_betas=toy.n_betas)
    ts = tpri.unity_shape_prior(str(tmp_path / "unity.npz"), n_betas=toy.n_betas)
    np.testing.assert_allclose(float(ts(torch.from_numpy(betas))), float(js(jnp.asarray(betas))),
                               rtol=1e-5)
    np.testing.assert_allclose(ts.precs.numpy(), np.asarray(js.precs), rtol=1e-6)


def test_model_pickle_round_trip_matches_jax(tmp_path, toy):
    path = write_model_pkl(str(tmp_path / "toy.pkl"), toy)
    dd = tauth.import_model_pkl(path)
    jdd = jauth.import_model_pkl(path)
    assert set(dd) == set(jdd)
    for k in dd:
        np.testing.assert_array_equal(np.asarray(dd[k]), np.asarray(jdd[k]), err_msg=k)
    spec = load_model_spec(path, align_symmetry=False, device="cpu")
    jspec = jax_load_model_spec(path, align_symmetry=False)
    assert not torch.equal(spec.faces, toy.faces)                 # Morton-sorted on load
    for k in ("v_template", "faces", "shapedirs", "posedirs", "J_regressor", "weights",
              "shape_mean_betas", "shape_cov"):
        np.testing.assert_array_equal(getattr(spec, k).numpy(),
                                      np.asarray(getattr(jspec, k)).astype(
                                          getattr(spec, k).numpy().dtype), err_msg=k)
    assert spec.parents == tuple(int(p) for p in np.asarray(jspec.parents))
    for k in ("joint_names", "torso_joints", "ignore_joints", "n_betas", "root_joint"):
        assert tuple(np.atleast_1d(getattr(spec, k))) == tuple(np.atleast_1d(getattr(jspec, k))), k
    assert spec.torso_joints == toy.torso_joints
    # the JAX writer's pickle loads to the same arrays
    jpath = jauth.export_model_pkl(
        str(tmp_path / "j.pkl"), jdd["v_template"], jdd["f"], jdd["J_regressor"],
        jdd["kintree_table"], jdd["weights"], jdd["J_names"], shapedirs=jdd["shapedirs"],
        posedirs=jdd["posedirs"], shape_cov=jdd["shape_cov"],
        shape_mean_betas=jdd["shape_mean_betas"])
    for k, v in tauth.import_model_pkl(jpath).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(dd[k]), err_msg=k)
    with pytest.raises(ValueError, match="weights shape"):
        tauth.export_model_pkl(str(tmp_path / "bad.pkl"), dd["v_template"], dd["f"],
                               dd["J_regressor"], dd["kintree_table"], dd["weights"][:-1],
                               dd["J_names"])


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequence(tmp_path_factory, toy):
    """A model pickle and a 2-frame replicAnt sequence of it at 64²."""
    root = tmp_path_factory.mktemp("seq")
    model = write_model_pkl(str(root / "toy.pkl"), toy)
    spec = load_model_spec(model, align_symmetry=False, device="cpu")
    coco, names = write_replicant_sequence(str(root), spec, 2, SIZE)
    return model, spec, coco, names


def _assert_loaded_equal(got, want, rgb_atol=0.0):
    (garr, gnames), (warr, wnames) = got, want
    assert gnames == wnames
    for i, (g, w) in enumerate(zip(garr, warr)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if i == 0 and rgb_atol:
            np.testing.assert_allclose(g, w, atol=rgb_atol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.mark.parametrize("use_crop", [False, True])
def test_load_smil_sequence_matches_jax(sequence, use_crop):
    _, spec, coco, names = sequence
    kw = dict(joint_names=spec.joint_names, ignore_joints=[spec.joint_names[3]], use_crop=use_crop)
    for name in names:
        want = jload.load_smil_sequence(coco, name, 40, **kw)
        got = tload.load_smil_sequence(coco, name, 40, **kw)
        _assert_loaded_equal(got, want, rgb_atol=1e-5 if use_crop else 0.0)
        assert got[0][1].sum() > 20 and got[0][3][0, 3] == 0


def test_badja_and_stanford_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "joint_annotations")
    os.makedirs(tmp_path / "img")
    seq = []
    for i in range(3):
        rgb = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        seg = np.zeros((24, 32, 3), np.uint8)
        seg[6 + i:18, 8:20 + i] = 255
        image_io.write_png(tmp_path / "img" / f"{i}.png", rgb)
        image_io.write_png(tmp_path / "img" / f"{i}_seg.png", seg)
        seq.append({"image_path": f"img/{i}.png", "segmentation_path": f"img/{i}_seg.png",
                    "joints": rng.uniform(0, 48, (6, 2)).tolist(),
                    "visibility": rng.randint(0, 2, 6).tolist()})
    seq.append({"image_path": "img/missing.png", "segmentation_path": "img/missing.png",
                "joints": [[0, 0]] * 6, "visibility": [1] * 6})
    (tmp_path / "joint_annotations" / "dog.json").write_text(json.dumps(seq))
    classes = [0, 2, 4, 5, 1]
    for rng_ in (None, [0, 2, 3]):
        _assert_loaded_equal(tload.load_badja_sequence(str(tmp_path), "dog", 32, classes, rng_),
                             jload.load_badja_sequence(str(tmp_path), "dog", 32, classes, rng_),
                             rgb_atol=1e-5)

    os.makedirs(tmp_path / "sample_imgs")
    image_io.write_png(tmp_path / "sample_imgs" / "d.png",
                       rng.randint(0, 256, (20, 30, 3)).astype(np.uint8))
    runs = [130, 40, 200, 30, 200]                    # column-major runs of a 20×30 mask
    runs.append(600 - sum(runs))
    (tmp_path / "StanfordExtra_sample.json").write_text(json.dumps([{
        "img_path": "d.png", "img_height": 20, "img_width": 30, "seg": runs,
        "joints": rng.uniform(0, 20, (5, 3)).tolist()}]))
    _assert_loaded_equal(tload.load_stanford_sequence(str(tmp_path), "d.png", 24),
                         jload.load_stanford_sequence(str(tmp_path), "d.png", 24), rgb_atol=1e-5)
    np.testing.assert_array_equal(tload._decode_coco_rle("0b3Q1", 4, 3),
                                  jload._decode_coco_rle("0b3Q1", 4, 3))


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------


def _ply_vertices(path):
    lines = open(path).read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    start = lines.index("end_header") + 1
    return np.array([[float(x) for x in ln.split()] for ln in lines[start:start + n]])


def _final(out_dir, frame):
    base = os.path.join(out_dir, os.path.splitext(frame)[0], "st10_ep0")
    with open(base + ".pkl", "rb") as f:
        params = pickle.load(f)
    return params, _ply_vertices(base + ".ply"), image_io.read_png(base + ".png").astype(int)


def test_fitter_clis_match_jax(sequence, tmp_path):
    from smilify_tpu.cli import optimize_to_joints as jcli
    from smilify_tpu_torch.cli import optimize_corpus as tcorpus
    from smilify_tpu_torch.cli import optimize_to_joints as tcli

    model, spec, coco, names = sequence
    base = ["--model", model, "--data-root", coco, "--test", "--test-stages", "2"]
    one = base + ["--sequence", f"replicAnt:{names[0]}", "--exact"]
    jcli.main(one + ["--output-dir", str(tmp_path / "jax")])
    tcli.main(one + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    jp, jv, jc = _final(tmp_path / "jax", names[0])
    tp, tv, tc = _final(tmp_path / "port", names[0])
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    assert tc.shape == jc.shape == (SIZE, 4 * SIZE, 3) and np.abs(tc - jc).max() <= 1
    frame_dir = tmp_path / "port" / os.path.splitext(names[0])[0]
    assert {p.name for p in frame_dir.iterdir()} == {
        f"st{s}_ep0.{e}" for s in (0, 1, 10) for e in ("png", "pkl", "ply")}

    # the corpus CLI: two one-frame clips in one batched fit, clip 0 as its own fit
    tcorpus.main(base + ["--all-replicant", "--output-dir", str(tmp_path / "corpus"),
                         "--device", "cpu"])
    cp, cv, _ = _final(tmp_path / "corpus", names[0])
    for k in jp:
        np.testing.assert_allclose(cp[k], tp[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(cv, tv, atol=1e-4)
    assert (tmp_path / "corpus" / os.path.splitext(names[1])[0] / "st10_ep0.ply").exists()

    # resume from the port's final export: stage 0 freezes joint_rot and betas,
    # so they stay the checkpoint's; the Phong render fills the collage's panel
    tcli.main(base[:-1] + ["1", "--sequence", f"replicAnt:{names[0]}", "--exact", "--texture",
                           "--load-checkpoint", str(tmp_path / "port"),
                           "--output-dir", str(tmp_path / "resumed"), "--device", "cpu"])
    rp, _, rc = _final(tmp_path / "resumed", names[0])
    ck = load_fitter_checkpoint(str(tmp_path / "port"), [names[0]], 10, "0")
    np.testing.assert_array_equal(rp["joint_rotations"], ck["joint_rot"][0])
    np.testing.assert_array_equal(rp["betas"], ck["betas"])
    assert np.abs(rp["joint_rotations"]).max() > 0
    assert rc.shape == tc.shape and (rc[:, SIZE:2 * SIZE] != tc[:, SIZE:2 * SIZE]).any()

    tcli.main(base[:-1] + ["2", "--sequence", f"replicAnt:{names[1]}", "--progressive", "1,2",
                           "--output-dir", str(tmp_path / "prog"), "--device", "cpu"])
    pp, pv, _ = _final(tmp_path / "prog", names[1])
    assert all(np.isfinite(v).all() for v in pp.values()) and np.isfinite(pv).all()


def test_scene_debug_matches_jax_and_plots_write(tmp_path, toy):
    from smilify_tpu.render.cameras import default_camera as jax_default_camera
    from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

    verts, _, _ = _posed_view(toy)
    kp = verts[::7]
    got = tvis.render_scene_debug(toy, default_camera(device="cpu"), verts, kp, (32, 32))
    want = jvis.render_scene_debug(jax_toy_spec(8, 6, 3), jax_default_camera(),
                                   verts.numpy(), kp.numpy(), (32, 32))
    assert got.shape == want.shape == (32, 32, 3)
    assert (np.abs(got - np.asarray(want)) <= 1.0 / 255 + 1e-6).mean() >= 0.999
    f = toy.faces.numpy()
    paths = [tvis.plot_mesh(verts, f, str(tmp_path / "m.png")),
             tvis.plot_pointclouds([verts, kp], str(tmp_path / "p.png")),
             tvis.plot_mesh_heatmap(verts, f, np.arange(len(f)), str(tmp_path / "h.png"))]
    assert all(os.path.getsize(p) > 0 for p in paths)
