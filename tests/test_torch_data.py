"""Parity of the port's jax-free data modules (smilify_tpu_torch.data: the
canonical frame, augmentation, the sample cache, the HDF5 schema, dataset
mixing, replicAnt, SLEAP, session preprocessing, dataset tools, video) with
the JAX package's on the CPU.

Inputs are made from a numpy seed or written by the test (HDF5 with h5py,
JPG/PNG frames and videos with OpenCV). Both packages run the same code
apart from three replacements, each held here to the library it replaces:
the Rodrigues rotation (scipy in place of ``cv2.Rodrigues``: within 1e-12),
the float image resize of the replicAnt loader (``utils/image_io.resize`` in
place of ``cv2.resize``: within 1e-5) and the PNG reader (in place of
imageio: exact). Every other output is equal exactly, or, where
a Rodrigues matrix feeds a solver, within 1e-9 relative (triangulation), or
within 1e-4 (the refined cameras, where the reprojection error agrees to
1e-6).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os

import cv2
import h5py
import numpy as np
import pytest

from smilify_tpu.data import augmentation as jaug
from smilify_tpu.data import cache as jcache
from smilify_tpu.data import canonical_frame as jcf
from smilify_tpu.data import combined as jcomb
from smilify_tpu.data import dataset_tools as jtools
from smilify_tpu.data import hdf5_dataset as jh5
from smilify_tpu.data import preprocess_multiview as jpm
from smilify_tpu.data import replicant as jrep
from smilify_tpu.data import sleap as jsl
from smilify_tpu.data import sleap_raw as jraw
from smilify_tpu.data import video as jvid

from smilify_tpu_torch.data import augmentation as taug
from smilify_tpu_torch.data import cache as tcache
from smilify_tpu_torch.data import canonical_frame as tcf
from smilify_tpu_torch.data import combined as tcomb
from smilify_tpu_torch.data import dataset_tools as ttools
from smilify_tpu_torch.data import hdf5_dataset as th5
from smilify_tpu_torch.data import preprocess_multiview as tpm
from smilify_tpu_torch.data import replicant as trep
from smilify_tpu_torch.data import sleap as tsl
from smilify_tpu_torch.data import sleap_raw as traw
from smilify_tpu_torch.data import video as tvid

RODRIGUES_TOL = 1e-12
SOLVE_RTOL = 1e-9
REFINE_RTOL = 1e-4
FLOAT_RESIZE_TOL = 1e-5          # tests/test_torch_cli.py: cv2.resize against interpolate


def assert_same(a, b, path="", rtol=0.0, atol=0.0):
    """``a`` and ``b`` equal: dicts key by key, lists item by item, arrays
    with the tolerances given (exactly by default)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}", rtol, atol)
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (int, float, str))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", rtol, atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        if rtol or atol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _rotations(rng, n):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return axes * rng.uniform(0.05, np.pi - 0.05, (n, 1))


def _mv_samples(rng, n=4, v=3, k=6, res=32):
    """Multi-view writer samples with a varying number of views, smooth
    images and cameras at metre scale."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    out = []
    for i in range(n):
        nv = v if i % 2 == 0 else v - 1
        R = np.stack([cv2.Rodrigues(r)[0] for r in _rotations(rng, nv)]).astype(np.float32)
        out.append({
            "images": [(np.stack([yy, xx, yy * xx], -1) * 200 + 20 + 10 * j).astype(np.uint8)
                       for j in range(nv)],
            "camera_indices": list(range(nv)),
            "camera_names": [f"cam{j}" for j in range(nv)],
            "keypoints_2d": (rng.rand(nv, k, 2) * res).astype(np.float32),
            "keypoint_visibility": (rng.rand(nv, k) > 0.2).astype(np.float32),
            "camera_intrinsics": np.tile(np.array([[40, 0, 16], [0, 40, 16], [0, 0, 1]],
                                                  np.float32), (nv, 1, 1)),
            "camera_extrinsics_R": R,
            "camera_extrinsics_t": (rng.rand(nv, 3) + [0, 0, 2]).astype(np.float32),
            "image_sizes": np.full((nv, 2), res, np.int32),
            "keypoints_3d": rng.rand(k, 3).astype(np.float32) if i != 1 else None,
            "global_rot": rng.rand(3).astype(np.float32),
            "joint_rot": rng.rand(k - 1, 3).astype(np.float32),
            "betas": rng.rand(4).astype(np.float32),
            "trans": rng.rand(3).astype(np.float32),
            "session_name": f"sess{i % 2}",
            "frame_idx": 10 + i,
        })
    return out


def _sv_samples(rng, n=3, k=6, res=32):
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    return [{
        "image": (np.stack([xx, yy, xx * yy], -1) * 200 + 30).astype(np.uint8),
        "keypoints_2d": rng.rand(k, 2).astype(np.float32),
        "keypoint_visibility": np.ones(k, np.float32),
        "global_rot": rng.rand(3).astype(np.float32),
        "joint_rot": rng.rand(k - 1, 3).astype(np.float32),
        "betas": rng.rand(4).astype(np.float32),
        "trans": rng.rand(3).astype(np.float32),
        "fov": np.float32(30 + i),
        "cam_rot": rng.rand(3, 3).astype(np.float32),
        "cam_trans": rng.rand(3).astype(np.float32),
        "silhouette": (xx > 0.3 + 0.1 * i).astype(np.float32),
        "session_name": "s",
        "camera_name": f"c{i}",
        "frame_idx": i,
        "keypoints_3d_sleap": rng.rand(k, 3).astype(np.float32),
    } for i in range(n)]


def _write_mv(mod, path, samples, v=3):
    mod.write_multiview_hdf5(path, samples, max_views=v, target_resolution=32,
                             canonical_camera_order=[f"cam{i}" for i in range(v)],
                             n_pose=5, n_betas=4, extra_metadata={"crop_mode": "default"})
    return path


def _h5_contents(path):
    """Every dataset and attribute of an HDF5 file, as numpy."""
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            data = obj[()]
            if obj.dtype.kind == "O":
                data = [bytes(np.asarray(x)) if not isinstance(x, bytes) else x for x in data]
            out[name] = data
        out[name + "@attrs"] = {k: np.asarray(v) for k, v in obj.attrs.items()}

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


# ---------------------------------------------------------------------------
# canonical frame and the Rodrigues replacement
# ---------------------------------------------------------------------------


def test_rodrigues_replacements_match_cv2():
    rng = np.random.default_rng(0)
    for r in _rotations(rng, 64):
        R_cv = cv2.Rodrigues(r.reshape(3, 1))[0]
        R_t = tcf.rodrigues_to_matrix(r)
        assert np.abs(R_t - R_cv).max() <= RODRIGUES_TOL
        assert np.abs(tcf.matrix_to_rodrigues(R_cv) - cv2.Rodrigues(R_cv)[0].reshape(3)).max() \
            <= RODRIGUES_TOL
        cal = dict(name="c", size=(64, 48), matrix=np.eye(3), distortions=np.zeros(5),
                   rotation=r, translation=np.ones(3))
        assert np.abs(tsl.CameraCalibration(**cal).R - jsl.CameraCalibration(**cal).R).max() \
            <= RODRIGUES_TOL
    M = cv2.Rodrigues(np.array([0.3, -0.2, 0.5]))[0]
    for aa in _rotations(rng, 16):
        assert np.abs(tcf.rotate_axis_angle_left(aa, M) - jcf.rotate_axis_angle_left(aa, M)).max() \
            <= RODRIGUES_TOL


def test_canonical_frame_matches_jax():
    rng = np.random.default_rng(1)
    V, K = 4, 7
    R = np.stack([cv2.Rodrigues(r)[0] for r in _rotations(rng, V)])
    t = rng.normal(size=(V, 3)) + [0, 0, 3]
    kp3d = rng.normal(size=(K, 3))
    kp3d[2] = 0.0                                   # the no-GT sentinel
    mask = np.array([False, True, True, False])
    assert_same(tcf.canonicalize_sample(R, t, kp3d, mask), jcf.canonicalize_sample(R, t, kp3d, mask))
    Kc = np.array([[300.0, 0, 60], [0, 280.0, 50], [0, 0, 1]])
    assert_same(tcf.camera_from_opencv_np(R[0], t[0], Kc, (100, 120)),
                jcf.camera_from_opencv_np(R[0], t[0], Kc, (100, 120)))
    got, want = tcf.recanonicalize_single_view(R[1], t[1], kp3d), \
        jcf.recanonicalize_single_view(R[1], t[1], kp3d)
    assert_same(got, want)
    R0, t0 = R[1], t[1]
    assert_same(tcf.decanonicalize_points(kp3d, R0, t0), jcf.decanonicalize_points(kp3d, R0, t0))
    assert_same(tcf.project_world_to_pixel(kp3d, R0, t0, Kc),
                jcf.project_world_to_pixel(kp3d, R0, t0, Kc))
    assert_same(tcf.cam_center_world(R0, t0), jcf.cam_center_world(R0, t0))
    yx = rng.uniform(size=(K, 2))
    assert_same(tcf.kp2d_norm_yx_to_pixel_xy(yx, 120, 100), jcf.kp2d_norm_yx_to_pixel_xy(yx, 120, 100))
    for scale in (1.0, 100.0):
        assert tcf.infer_world_scale(t * scale, mask) == jcf.infer_world_scale(t * scale, mask)


# ---------------------------------------------------------------------------
# augmentation and the decoded-sample cache
# ---------------------------------------------------------------------------


def test_augmentation_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    Km = np.array([[50.0, 0, 24], [0, 50.0, 20], [0, 0, 1]])
    kp = rng.uniform(0, 40, (5, 2))
    for blur, erase in ((1.0, 1.0), (0.0, 0.0)):
        kw = dict(gaussian_blur_prob=blur, random_erasing_prob=erase, geometric_enabled=True,
                  crop_jitter_fraction=0.1)
        jp, tp = jaug.AugmentationParams(**kw), taug.AugmentationParams(**kw)
        for seed in range(3):
            assert_same(taug.photometric_augment(img, np.random.default_rng(seed), tp),
                        jaug.photometric_augment(img, np.random.default_rng(seed), jp))
            assert_same(list(taug.geometric_scale_jitter(img, Km, np.random.default_rng(seed), tp, kp)),
                        list(jaug.geometric_scale_jitter(img, Km, np.random.default_rng(seed), jp, kp)))
            assert_same(list(taug.geometric_crop_jitter(img, Km, np.random.default_rng(seed), tp, kp)),
                        list(jaug.geometric_crop_jitter(img, Km, np.random.default_rng(seed), jp, kp)))
        mv = {"images": np.stack([img, img[::-1]]), "camera_intrinsics": np.stack([Km, Km]),
              "keypoints_2d": np.stack([kp, kp]), "view_mask": np.array([True, False])}
        assert_same(taug.augment_multiview_sample(mv, np.random.default_rng(4), tp),
                    jaug.augment_multiview_sample(mv, np.random.default_rng(4), jp))
        sv = {"image": img, "x": np.arange(3)}
        assert_same(taug.augment_singleview_sample(sv, np.random.default_rng(5), tp),
                    jaug.augment_singleview_sample(sv, np.random.default_rng(5), jp))
        data = [mv, sv, {"y": np.zeros(2)}]
        ta, ja = taug.AugmentedDataset(data, tp, seed=7), jaug.AugmentedDataset(data, jp, seed=7)
        for ds in (ta, ja):
            ds.set_epoch(3)
        assert len(ta) == len(ja) == 3
        for i in range(3):
            assert_same(ta[i], ja[i])


def test_decoded_sample_cache_matches_jax():
    class Counting(list):
        reads = 0

        def __getitem__(self, i):
            type(self).reads += 1
            return list.__getitem__(self, i)

    data = [{"a": np.full(100, i, np.float32), "n": i} for i in range(6)]
    for eager in (False, True):
        caches = [mod.DecodedSampleCache(Counting(data), max_bytes=1500, eager=eager)
                  for mod in (tcache, jcache)]
        for c in caches:
            for i in (0, 3, 0, 5, 3):
                c[i]
        assert_same(caches[0].cache_info(), caches[1].cache_info())
        assert_same(caches[0][5], caches[1][5])
        assert len(caches[0]) == len(caches[1]) == 6


# ---------------------------------------------------------------------------
# the HDF5 schema, and datasets over it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mv_files(tmp_path_factory):
    """One multi-view sample list written by each package's writer."""
    d = tmp_path_factory.mktemp("mv")
    samples = _mv_samples(np.random.RandomState(3))
    return {"jax": _write_mv(jh5, str(d / "jax.h5"), samples),
            "torch": _write_mv(th5, str(d / "torch.h5"), samples)}


def test_multiview_writers_write_the_same_file(mv_files):
    assert_same(_h5_contents(mv_files["torch"]), _h5_contents(mv_files["jax"]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_multiview_file_reads_the_same_through_both(mv_files, writer):
    path = mv_files[writer]
    assert th5.detect_dataset_type(path) == jh5.detect_dataset_type(path) == "sleap_multiview"
    modes = [{}, {"num_views_to_use": 2, "view_sampling": "random", "seed": 3},
             {"num_views_to_use": 2, "view_sampling": "first"}, {"min_views": 3},
             {"world_scale": 0.5},
             {"return_single_view": True, "preferred_view": 1},
             {"return_single_view": True, "camera_centric": True},
             {"return_single_view": True, "expand_all_views": True, "min_views": 2}]
    for kw in modes:
        t, j = th5.MultiViewHDF5Dataset(path, **kw), jh5.MultiViewHDF5Dataset(path, **kw)
        assert len(t) == len(j) > 0, kw
        assert_same(t.metadata, j.metadata)
        assert t.world_scale == j.world_scale
        got = [t[i] for i in range(len(t))]
        want = [j[i] for i in range(len(j))]
        for g, w in zip(got, want):
            if kw.get("camera_centric"):
                # through the Rodrigues replacement (1e-12 in float64), then
                # rounded to float32: at most one float32 step apart
                np.testing.assert_allclose(g.pop("global_rot"), w.pop("global_rot"),
                                           rtol=1.2e-7, atol=1e-12)
            assert_same(g, w)
        if getattr(t, "item_sample_indices", None) is not None:
            assert_same(t.item_sample_indices, j.item_sample_indices)
        if not kw.get("return_single_view"):
            assert_same(th5.collate_multiview(got), jh5.collate_multiview(want))
        t.close()
        j.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_singleview_file_reads_the_same_through_both(tmp_path, writer):
    samples = _sv_samples(np.random.RandomState(4))
    paths = {}
    for name, mod in (("jax", jh5), ("torch", th5)):
        paths[name] = str(tmp_path / f"{name}.h5")
        mod.write_singleview_hdf5(paths[name], samples, 32, n_pose=15, n_betas=4)
    assert_same(_h5_contents(paths["torch"]), _h5_contents(paths["jax"]))
    path = paths[writer]
    assert th5.detect_dataset_type(path) == jh5.detect_dataset_type(path) == "optimized_hdf5"
    t, j = th5.SingleViewHDF5Dataset(path), jh5.SingleViewHDF5Dataset(path)
    assert_same(t.metadata, j.metadata)
    assert len(t) == len(j) == 3
    for i in range(3):
        assert_same(t[i], j[i])


def test_jpeg_codec_matches_jax():
    img = (np.random.default_rng(5).uniform(size=(24, 20, 3)) * 255).astype(np.uint8)
    assert_same(th5.encode_jpeg(img, 85), jh5.encode_jpeg(img, 85))
    assert_same(th5.decode_jpeg(jh5.encode_jpeg(img)), jh5.decode_jpeg(jh5.encode_jpeg(img)))


def test_combined_matches_jax(mv_files, tmp_path):
    sv = str(tmp_path / "sv.h5")
    jh5.write_singleview_hdf5(sv, _sv_samples(np.random.RandomState(6), n=2), 32, 15, 4)
    for path in (mv_files["jax"], sv):
        t, j = tcomb.open_dataset(path), jcomb.open_dataset(path)
        assert type(t).__name__ == type(j).__name__
        assert_same(t[0], j[0])
    entries = lambda mod, h5: [  # noqa: E731
        {"dataset": h5.MultiViewHDF5Dataset(mv_files["jax"]), "weight": 2.0, "name": "mv",
         "available_labels": {"betas": False}},
        {"dataset": h5.SingleViewHDF5Dataset(sv), "weight": 1.0}]
    t, j = tcomb.CombinedDataset(entries(tcomb, th5)), jcomb.CombinedDataset(entries(jcomb, jh5))
    assert len(t) == len(j) == 6
    assert_same(t.group_ids, j.group_ids)
    assert_same(t.sampling_weights(), j.sampling_weights())
    assert_same(t.sample_indices(9, np.random.default_rng(0)),
                j.sample_indices(9, np.random.default_rng(0)))
    for i in range(len(t)):
        assert_same(t[i], j[i])


def test_dataset_tools_match_jax(mv_files, tmp_path):
    a, b = mv_files["jax"], str(tmp_path / "b.h5")
    _write_mv(jh5, b, _mv_samples(np.random.RandomState(8), n=2, v=2), v=2)
    for name, mod in (("jax", jtools), ("torch", ttools)):
        d = tmp_path / name
        d.mkdir()
        mod.merge_multiview_datasets([a, b], str(d / "merged.h5"), scale_factors=[1.0, 2.0])
        _, stats = mod.filter_multiview_dataset(a, str(d / "filtered.h5"), min_visible_keypoints=4,
                                                min_views=2)
        (d / "stats.json").write_text(json.dumps(stats))
        mod.match_scale_multiview_dataset(a, str(d / "scaled.h5"), 0.25)
    for f in ("merged.h5", "filtered.h5", "scaled.h5"):
        assert_same(_h5_contents(str(tmp_path / "torch" / f)), _h5_contents(str(tmp_path / "jax" / f)))
    assert (tmp_path / "torch" / "stats.json").read_text() == (tmp_path / "jax" / "stats.json").read_text()
    assert ttools.estimate_world_scale_ratio(a, b) == jtools.estimate_world_scale_ratio(a, b)


# ---------------------------------------------------------------------------
# replicAnt frames
# ---------------------------------------------------------------------------


def _quat(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return dict(zip("xyzw", map(float, q)))


def write_unreal_frames(folder, joint_names, n_frames, size=(60, 80), seed=0, depth=False):
    """replicAnt frames as Unreal writes them: ``<folder>/<name>_<i>.json``
    with a JPG, an ``_ID.png`` mask (and, with ``depth``, a ``_D.png``
    depth pass), and the folder's ``_BatchData_<name>.json``."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    name = os.path.basename(folder)
    H, W = size
    with open(os.path.join(folder, f"_BatchData_{name}.json"), "w") as f:
        json.dump({"Image Resolution": {"x": W, "y": H}}, f)
    paths = []
    for i in range(n_frames):
        vm = {k: dict(zip("xyz", map(float, rng.normal(size=3)))) for k in
              ("xPlane", "yPlane", "zPlane", "wPlane")}
        keypoints = {}
        for j, jn in enumerate(joint_names):
            keypoints[jn] = {
                "quaternion": _quat(rng), "globalRotation": _quat(rng),
                "3DPos": dict(zip("xyz", map(float, rng.normal(size=3) * 50 + [0, 0, 300]))),
                "2DPos": {"x": float(rng.uniform(-5, W + 5)), "y": float(rng.uniform(0, H))},
            }
        subject = {"keypoints": keypoints, "shape betas": {f"b{k}": float(v) for k, v in
                                                           enumerate(rng.normal(size=4))},
                   "ScaleWeights": list(map(float, rng.normal(size=3))),
                   "TranslationWeights": list(map(float, rng.normal(size=3)))}
        data = {"iterationData": {"camera": {"View Matrix": vm, "FOV": float(40 + 5 * i),
                                             "Location": {"x": 1.0, "y": 2.0, "z": -30.0}},
                                  "subject Data": [{"SMIL_0": subject}]}}
        stem = os.path.join(folder, f"{name}_{i:02d}")
        with open(stem + ".json", "w") as f:
            json.dump(data, f)
        yy, xx = np.mgrid[0:H, 0:W]
        img = np.stack([xx * 3 % 256, yy * 4 % 256, (xx + yy + 40 * i) % 256], -1).astype(np.uint8)
        cv2.imwrite(stem + ".JPG", img)
        mask = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2 < (H / 3) ** 2).astype(np.uint8) * 200
        cv2.imwrite(stem + "_ID.png", np.stack([mask] * 3, -1))
        if depth:
            cv2.imwrite(stem + "_D.png", np.stack([(xx * 2 % 256).astype(np.uint8)] * 3, -1))
        paths.append(stem + ".json")
    return paths


JOINTS = ("root", "j1", "j2", "j3", "j4")


def test_replicant_matches_jax(tmp_path):
    paths = write_unreal_frames(str(tmp_path / "trial"), JOINTS[:4] + ("extra",), 3, depth=True)
    names = list(JOINTS)                      # "j4" is missing from the frames, "extra" unused
    for p in paths:
        assert_same(trep.load_smil_unreal_sample(p, names), jrep.load_smil_unreal_sample(p, names))
    for size in (None, 40):
        t = trep.ReplicantDataset(str(tmp_path / "trial"), names, image_size=size)
        j = jrep.ReplicantDataset(str(tmp_path / "trial"), names, image_size=size)
        assert len(t) == len(j) == 3
        for i in range(3):
            got, want = t[i], j[i]
            assert_same({k: v for k, v in got.items() if k != "image"},
                        {k: v for k, v in want.items() if k != "image"})
            np.testing.assert_allclose(got["image"], want["image"], atol=FLOAT_RESIZE_TOL, rtol=0)
    rng = np.random.default_rng(9)
    sd, td = rng.normal(size=(5, 3, 3)), rng.normal(size=(3, 5, 3))
    assert_same(trep.sample_pca_transforms_from_dirs(sd, td, [0.1, 0.2, 0.3], [1, 2, 3]),
                jrep.sample_pca_transforms_from_dirs(sd, td, [0.1, 0.2, 0.3], [1, 2, 3]))


# ---------------------------------------------------------------------------
# SLEAP: calibration, triangulation, refinement; raw predictions and video
# ---------------------------------------------------------------------------


def _calibrations(mod, n=3, distort=True):
    rng = np.random.default_rng(10)
    cams = []
    for i in range(n):
        rot = np.array([0.0, 0.5 * i, 0.05 * i])
        cams.append(mod.CameraCalibration(
            name=f"cam{i}", size=(64, 48),
            matrix=np.array([[80.0 + i, 0, 32], [0, 82.0, 24], [0, 0, 1]]),
            distortions=np.array([0.01 * distort, -0.002 * distort, 0, 0, 0]),
            rotation=rot, translation=np.array([0.1 * i, 0.0, 3.0]) + rng.normal(0, 0.01, 3)))
    return cams


def test_sleap_toolchain_matches_jax(tmp_path):
    tc, jc = _calibrations(tsl), _calibrations(jsl)
    for name, mod, cams in (("t", tsl, tc), ("j", jsl, jc)):
        mod.save_calibration_toml(str(tmp_path / f"{name}.toml"), cams)
    assert (tmp_path / "t.toml").read_text() == (tmp_path / "j.toml").read_text()
    back_t, back_j = (mod.load_calibration_toml(str(tmp_path / "t.toml")) for mod in (tsl, jsl))
    for a, b in zip(back_t, back_j):
        assert_same(a.__dict__, b.__dict__)
        np.testing.assert_allclose(a.P, b.P, rtol=0, atol=RODRIGUES_TOL * np.abs(b.P).max())
    rng = np.random.default_rng(11)
    pts3d = rng.uniform(-0.3, 0.3, (4, 5, 3))
    proj = jsl.generate_reprojections(pts3d, jc)
    np.testing.assert_allclose(tsl.generate_reprojections(pts3d, tc), proj, rtol=SOLVE_RTOL)
    obs = proj + rng.normal(0, 0.3, proj.shape)
    obs[0, 1, 2] = np.nan
    scores = rng.uniform(0.2, 1.0, obs.shape[:3])
    for undistort in (True, False):
        got = tsl.triangulate_frames(obs, scores, tc, undistort=undistort)
        want = jsl.triangulate_frames(obs, scores, jc, undistort=undistort)
        assert_same(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=SOLVE_RTOL, atol=0)
    assert tsl.reprojection_error(tc, pts3d, obs, scores) == pytest.approx(
        jsl.reprojection_error(jc, pts3d, obs, scores), rel=SOLVE_RTOL)
    (ref_t, err_t), (ref_j, err_j) = (mod.refine_cameras(obs, scores, cams, n_outer=2)
                                      for mod, cams in ((tsl, tc), (jsl, jc)))
    # Levenberg-Marquardt from starts 1e-16 apart stops at points 2e-5 apart
    # along the flat directions of the reprojection error (focal against
    # depth): the error agrees to 1e-6, the parameters to REFINE_RTOL
    assert err_t == pytest.approx(err_j, rel=1e-6)
    for a, b in zip(ref_t, ref_j):
        np.testing.assert_allclose(a.matrix, b.matrix, rtol=REFINE_RTOL)
        np.testing.assert_allclose(a.rotation, b.rotation, rtol=REFINE_RTOL, atol=1e-6)
        np.testing.assert_allclose(a.translation, b.translation, rtol=REFINE_RTOL, atol=1e-6)
    tsl.write_points3d_h5(str(tmp_path / "p.h5"), pts3d, {"unit": "m"})
    assert_same(jsl.read_points3d_h5(str(tmp_path / "p.h5")), tsl.read_points3d_h5(str(tmp_path / "p.h5")))
    undist = rng.uniform(0, 60, (7, 2))
    assert_same(tc[1].undistort_points(undist), jc[1].undistort_points(undist))


NODES = ["Head", "Thorax", "tail_tip", "extra"]


def _write_video(path, n_frames, size=(48, 64)):
    H, W = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    for i in range(n_frames):
        img = np.zeros((H, W, 3), np.uint8)
        img[10:26, 4 + 5 * i: 16 + 5 * i] = (255, 180, 60)
        vw.write(img)
    vw.release()


def _write_session(root, n_frames=5, cams=("cam0", "cam1"), consistent=False):
    """A SLEAP session: per camera an MJPG video and an analysis-HDF5
    export (camera 1 as a native .slp table), plus a calibration. The 2D
    predictions are random, or (``consistent``) the calibrated projections
    of random 3D points with 0.3 px of noise."""
    rng = np.random.default_rng(12)
    os.makedirs(root, exist_ok=True)
    cals = _calibrations(jsl, len(cams))
    pts3d = rng.uniform(-0.3, 0.3, (n_frames, len(NODES), 3))
    for ci, cam in enumerate(cams):
        _write_video(os.path.join(root, f"{cam}.avi"), n_frames)
        if consistent:
            pts = np.stack([cals[ci].project(p) for p in pts3d]) + rng.normal(0, 0.3, (n_frames, len(NODES), 2))
        else:
            pts = rng.uniform(2, 46, (n_frames, len(NODES), 2))
        pts[1, :2] = np.nan
        sc = rng.uniform(0.1, 1.0, (n_frames, len(NODES))).astype(np.float32)
        if ci == 0:
            with h5py.File(os.path.join(root, f"{cam}.analysis.h5"), "w") as f:
                f["tracks"] = np.transpose(pts, (2, 1, 0))[None]
                f["point_scores"] = sc.T[None]
                f["node_names"] = np.asarray([n.encode() for n in NODES])
                f["edge_inds"] = np.asarray([[0, 1], [1, 2]])
        else:
            _write_slp(os.path.join(root, f"{cam}.slp"), pts, sc)
    jsl.save_calibration_toml(os.path.join(root, "calibration.toml"), cals)
    return root


def _write_slp(path, pts, scores):
    F, K, _ = pts.shape
    meta = {"skeletons": [{"nodes": [{"id": 10 + k} for k in range(K)],
                           "links": [{"source": 10, "target": 11}, {"source": 11, "target": 12}]}],
            "nodes": [{"id": 10 + k, "name": n} for k, n in enumerate(NODES)]}
    frames = np.zeros(F, [("frame_id", "<i8")])
    frames["frame_id"] = np.arange(F)
    inst = np.zeros(2 * F, [("frame_id", "<i8"), ("point_id_start", "<i8"), ("point_id_end", "<i8")])
    table = np.zeros(2 * F * K, [("x", "<f8"), ("y", "<f8"), ("score", "<f8")])
    for f in range(F):
        for i in range(2):                         # two instances a frame: read the first
            n = 2 * f + i
            inst[n] = (f, n * K, (n + 1) * K)
            table["x"][n * K:(n + 1) * K] = pts[f, :, 0] + 100 * i
            table["y"][n * K:(n + 1) * K] = pts[f, :, 1]
            table["score"][n * K:(n + 1) * K] = scores[f]
    with h5py.File(path, "w") as h:
        h.create_group("metadata").attrs["json"] = json.dumps(meta)
        h["frames"], h["instances"], h["pred_points"] = frames, inst, table


def test_sleap_raw_matches_jax(tmp_path):
    root = _write_session(str(tmp_path / "sess"))
    assert_same(traw.find_session_layout(root), jraw.find_session_layout(root))
    for fn in ("cam0.analysis.h5", "cam1.slp"):
        p = os.path.join(root, fn)
        assert_same(list(traw.read_sleap_predictions(p)), list(jraw.read_sleap_predictions(p)))
        assert_same(list(traw.read_skeleton(p)), list(jraw.read_skeleton(p)))
    p = os.path.join(root, "cam1.slp")
    assert_same(list(traw.read_slp(p, instance=1)), list(jraw.read_slp(p, instance=1)))
    csv = tmp_path / "lookup.csv"
    csv.write_text("sleap_name,model_name\nHead,j1\nThorax,J2\nextra,\n")
    lookup = traw.read_joint_lookup_csv(str(csv))
    assert lookup == jraw.read_joint_lookup_csv(str(csv))
    pts, sc, nodes = jraw.read_sleap_predictions(os.path.join(root, "cam0.analysis.h5"))
    assert_same(list(traw.map_keypoints_to_model(pts, sc, nodes, list(JOINTS) + ["tail_tip"], lookup)),
                list(jraw.map_keypoints_to_model(pts, sc, nodes, list(JOINTS) + ["tail_tip"], lookup)))
    video = os.path.join(root, "cam0.avi")
    for i in (3, 0, 7):                             # 7 is past the end
        assert_same(traw.read_video_frame(video, i), jraw.read_video_frame(video, i))
    with traw.SequentialVideoReader(video) as t, jraw.SequentialVideoReader(video) as j:
        assert t.n_frames == j.n_frames == 5
        for i in (0, 1, 4, 2):
            assert_same(t.read(i), j.read(i))


# ---------------------------------------------------------------------------
# session preprocessing and raw-video input
# ---------------------------------------------------------------------------


def test_crop_and_resize_matches_jax():
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:48, 0:64]
    u8 = np.stack([xx * 4 % 256, yy * 5 % 256, (xx * yy) % 256], -1).astype(np.uint8)
    Km = np.array([[70.0, 0, 32], [0, 70.0, 24], [0, 0, 1]])
    kp = rng.uniform(5, 40, (6, 2))
    kp[2] = np.nan
    for img in (u8, u8.astype(np.float32) / 255):
        for mode in ("default", "centred", "bbox_crop"):
            for res in (32, 96):
                t, j = tpm.crop_and_resize(img, kp, Km, res, mode), jpm.crop_and_resize(img, kp, Km, res, mode)
                assert t.image.dtype == j.image.dtype == np.float32
                assert_same([t.image, t.keypoints, t.K_new, t.offset, t.scale],
                            [j.image, j.keypoints, j.K_new, j.offset, j.scale])


def test_undistort_and_outlier_filter_match_jax():
    rng = np.random.default_rng(14)
    img = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    Km = np.array([[70.0, 0, 32], [0, 70.0, 24], [0, 0, 1]])
    kp = rng.uniform(5, 40, (6, 2))
    kp[1] = np.nan
    for dist in (np.zeros(5), np.array([0.05, -0.01, 0.001, 0.0, 0.0])):
        assert_same(list(tpm.undistort_view(img, kp, Km, dist)), list(jpm.undistort_view(img, kp, Km, dist)))
    pts = rng.normal(size=(12, 3))
    pts[3] = 0.0
    pts[5] = 40.0
    assert_same(tpm.filter_outlier_3d(pts), jpm.filter_outlier_3d(pts))


def test_preprocess_session_frames_matches_jax():
    rng = np.random.default_rng(15)
    cams = ["a", "b", "c"]
    frames = []
    for f in range(3):
        frame = {"frame_idx": f, "session_name": "s", "keypoints_3d": rng.normal(size=(5, 3))}
        for c in cams[: 3 - (f == 1)]:
            frame[c] = {"image": (rng.uniform(size=(40, 50, 3)) * 255).astype(np.uint8),
                        "keypoints_xy": rng.uniform(2, 38, (5, 2)), "scores": rng.uniform(size=5),
                        "K": np.array([[60.0, 0, 25], [0, 60.0, 20], [0, 0, 1]]),
                        "dist": np.array([0.02, 0, 0, 0, 0]), "R": np.eye(3), "t": rng.normal(size=3)}
        frames.append(frame)
    for mode in ("default", "centred", "bbox_crop"):
        got = tpm.preprocess_session_frames(frames, cams, 32, mode, min_views_per_sample=3)
        want = jpm.preprocess_session_frames(frames, cams, 32, mode, min_views_per_sample=3)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_same(g, w)


def test_video_frame_dataset_matches_jax(tmp_path):
    root = _write_session(str(tmp_path / "sess"), cams=("cam0",))
    video, preds = os.path.join(root, "cam0.avi"), os.path.join(root, "cam0.analysis.h5")
    for mode, kw in (("default", {}), ("centred", {"max_frames": 3}),
                     ("bbox_crop", {"sleap_predictions": preds, "joint_names": NODES[:3]})):
        t = tvid.VideoFrameDataset(video, resolution=32, crop_mode=mode, **kw)
        j = jvid.VideoFrameDataset(video, resolution=32, crop_mode=mode, **kw)
        assert len(t) == len(j)
        for i in range(len(t)):
            g, w = t[i], j[i]
            assert_same(g, w)
        t.close()
        j.close()
