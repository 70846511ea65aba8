"""Video export in the port, held to the JAX package on the CPU.

* ``utils/export.py::write_video``: an mp4 and an avi read back through
  ``cv2.VideoCapture`` with the frames' count and size; the same decoded
  frames as the JAX package's ``write_video`` writes; and the port's two
  guards, which the JAX version lacks: it raises where OpenCV cannot open
  the writer and on a frame of another size.
* ``cli/generate_video.py`` on a fitter run (per-frame ``st10_ep0.pkl`` and
  ``.png`` made from a numpy seed, a toy (8, 6, 3) model pickle) against the
  JAX CLI, both writing ``.avi``, their frames caught by patching
  ``write_video`` on each package's ``utils.export``: PR 5's Phong gate —
  face ids (each package's ``rasterize_hard`` on its own geometry) equal on
  ≥ 99.9% of the pixels, and the uint8 frames within 1 on those pixels;
  ``--collage`` gives the same frames exactly.
* ``cli/run_inference.py --video`` single- and multi-view on the converted
  toy checkpoints of ``tests/test_torch_inference.py`` against the JAX CLI.
  The random models' cameras see nothing, so both packages'
  ``PredictionSmoother.smooth_params`` are patched to put the cameras (and
  the root translation) where they see the predicted mesh, the same numpy
  values on both sides. The same video files with the same frame counts
  and sizes; the frames (Phong renders with the joints drawn) within one
  level but on at most 0.1% of the pixels, where the two models' float32
  predictions (within 2e-5, that file's tolerance) move a face edge or a
  joint marker.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import os
import pickle

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.core.lbs import smil_forward as jax_smil_forward
from smilify_tpu.core.spec import load_model_spec as jax_load_model_spec
from smilify_tpu.render import phong as jphong
from smilify_tpu.render.cameras import default_camera as jax_default_camera
from smilify_tpu.utils import animation_export as janim
from smilify_tpu.utils import export as jexport

from smilify_tpu_torch.cli import generate_video as t_generate_video
from smilify_tpu_torch.cli import run_inference as t_run_inference
from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
from smilify_tpu_torch.render import phong as tphong
from smilify_tpu_torch.render.cameras import DEFAULT_R, DEFAULT_T
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
from smilify_tpu_torch.utils import animation_export as tanim
from smilify_tpu_torch.utils import export as texport
from smilify_tpu_torch.utils.image_io import write_png
from tests.test_torch_inference import RES, _checkpoints

SIZE = 64
FRAMES = 4
FACE_ID_SHARE = 0.999      # PR 5's Phong gate (tests/test_torch_cli.py)
LEVELS = 1
EDGE_SHARE = 1e-3          # run_inference: pixels a model's rounding may move


def _read_back(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return frames, count


def _frames(n=5, shape=(48, 64, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_write_video_round_trip_and_matches_jax(tmp_path, ext):
    frames = _frames()
    path = texport.write_video(str(tmp_path / f"t{ext}"), frames, fps=15)
    got, count = _read_back(path)
    assert len(got) == count == len(frames)
    assert all(g.shape == frames[0].shape for g in got)
    jgot, _ = _read_back(jexport.write_video(str(tmp_path / f"j{ext}"), frames, fps=15))
    assert len(jgot) == len(got)
    for a, b in zip(got, jgot):
        np.testing.assert_array_equal(a, b)


def test_write_video_guards(tmp_path):
    frames = _frames(3)
    with pytest.raises(OSError, match="could not open"):
        texport.write_video(str(tmp_path / "missing" / "v.mp4"), frames)
    with pytest.raises(ValueError, match="frame 3"):
        texport.write_video(str(tmp_path / "v.avi"), frames + [np.zeros((8, 8, 3), np.uint8)])
    with pytest.raises(ValueError, match="no frames"):
        texport.write_video(str(tmp_path / "v.avi"), [])


# ---------------------------------------------------------------------------
# generate_video
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitter_run(tmp_path_factory):
    """A toy model pickle and a fitter run of FRAMES frames: st10_ep0.pkl
    with parameters from a seed (frame 1 without log_betascale, as an older
    export) and a collage st10_ep0.png each."""
    root = tmp_path_factory.mktemp("fit")
    spec = toy_model_spec(8, 6, 3, device="cpu")
    pkl = write_model_pkl(str(root / "toy.pkl"), spec)
    run = root / "run"
    rng = np.random.RandomState(5)
    J, B = spec.n_joints, spec.n_betas
    for i in range(FRAMES):
        d = run / f"frame_{i:03d}"
        d.mkdir(parents=True)
        p = {"global_rotation": rng.normal(0, 0.3, 3).astype(np.float32),
             "joint_rotations": rng.normal(0, 0.2, (J - 1, 3)).astype(np.float32),
             "betas": rng.normal(0, 0.5, B).astype(np.float32),
             "trans": rng.normal(0, 0.05, 3).astype(np.float32),
             "fov": np.float32(rng.uniform(45, 70)),
             "log_betascale": rng.normal(0, 0.1, (J, 3)).astype(np.float32),
             "betas_trans": rng.normal(0, 0.02, (J, 3)).astype(np.float32)}
        if i == 1:
            del p["log_betascale"]
        with open(d / "st10_ep0.pkl", "wb") as f:
            pickle.dump(p, f)
        write_png(str(d / "st10_ep0.png"), rng.randint(0, 256, (SIZE, 2 * SIZE, 3)).astype(np.uint8))
    return pkl, str(run)


def _catch(monkeypatch, module):
    """Patch ``module.write_video`` to keep the frames and still write the file."""
    caught = {}
    real = module.write_video

    def write_video(path, frames, fps=15):
        caught[path] = [np.asarray(f).copy() for f in frames]
        return real(path, frames, fps=fps)

    monkeypatch.setattr(module, "write_video", write_video)
    return caught


def _jax_face_ids(pkl, run):
    """Each frame's face ids as the JAX CLI's geometry gives them."""
    spec = jax_load_model_spec(pkl, align_symmetry=False)
    out = []
    for d in t_generate_video.frame_dirs(run):
        with open(os.path.join(d, "st10_ep0.pkl"), "rb") as f:
            p = pickle.load(f)
        theta = np.concatenate([p["global_rotation"][None], p["joint_rotations"].reshape(-1, 3)])
        ls = p.get("log_betascale")
        o = jax_smil_forward(spec, jnp.asarray(p["betas"][None]), jnp.asarray(theta[None]),
                             log_scales=jnp.asarray(ls[None]) if ls is not None else None,
                             joint_trans=jnp.asarray(p["betas_trans"][None]))
        verts = o.verts[0] + jnp.asarray(p["trans"])
        cam = jax_default_camera().replace(fov=jnp.asarray(float(np.atleast_1d(p["fov"])[0])))
        pv = cam.world_to_view(verts)
        ndc = jnp.concatenate([cam.view_to_ndc(pv)[:, :2], pv[:, 2:3]], axis=1)
        out.append(np.asarray(jphong.rasterize_hard(ndc, spec.faces, (SIZE, SIZE))[0]))
    return out


def test_generate_video_matches_jax(monkeypatch, tmp_path, fitter_run):
    from smilify_tpu.cli.generate_video import main as j_generate_video

    pkl, run = fitter_run
    jcaught, tcaught = _catch(monkeypatch, jexport), _catch(monkeypatch, texport)
    jpath, tpath = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    common = ["--checkpoint-dir", run, "--model", pkl, "--size", str(SIZE)]
    j_generate_video(common + ["--output", jpath])
    t_generate_video.main(common + ["--output", tpath, "--device", "cpu"])
    jframes, tframes = jcaught[jpath], tcaught[tpath]
    assert len(jframes) == len(tframes) == FRAMES

    spec = load_model_spec(pkl, align_symmetry=False, device="cpu")
    params = t_generate_video.read_frame_params(t_generate_video.frame_dirs(run), "st10_ep0")
    _, _, ndcs = t_generate_video.frame_geometry(spec, params)
    for i, jfid in enumerate(_jax_face_ids(pkl, run)):
        fid = tphong.rasterize_hard(ndcs[i], spec.faces, (SIZE, SIZE))[0].numpy()
        same = fid == jfid
        assert same.mean() >= FACE_ID_SHARE and (fid >= 0).mean() > 0.02, i
        diff = np.abs(tframes[i].astype(int) - jframes[i].astype(int))
        assert diff[same].max() <= LEVELS, i
    got, count = _read_back(tpath)
    assert len(got) == count == FRAMES and got[0].shape == (SIZE, SIZE, 3)


def test_generate_video_collage_matches_jax(monkeypatch, tmp_path, fitter_run):
    from smilify_tpu.cli.generate_video import main as j_generate_video

    pkl, run = fitter_run
    jcaught, tcaught = _catch(monkeypatch, jexport), _catch(monkeypatch, texport)
    jpath, tpath = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    common = ["--checkpoint-dir", run, "--model", pkl, "--collage"]
    j_generate_video(common + ["--output", jpath])
    t_generate_video.main(common + ["--output", tpath])
    assert len(tcaught[tpath]) == FRAMES
    for a, b in zip(tcaught[tpath], jcaught[jpath]):
        np.testing.assert_array_equal(a, b)
    got, count = _read_back(tpath)
    assert len(got) == count == FRAMES and got[0].shape == (SIZE, 2 * SIZE, 3)


def test_generate_video_needs_a_card_unless_asked(monkeypatch, fitter_run):
    pkl, run = fitter_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_generate_video.main(["--checkpoint-dir", run, "--model", pkl])


# ---------------------------------------------------------------------------
# run_inference --video
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    spec = toy_model_spec(8, 6, 3, device="cpu")
    return spec, write_model_pkl(str(root / "toy.pkl"), spec)


def _framed(traj):
    """``traj`` with the root translation zeroed and each camera (each view's
    rotated about y by up to 90°) at the default camera's distance, fov 50-60°."""
    from scipy.spatial.transform import Rotation

    out = dict(traj)
    n = len(traj["global_rot"])
    if "trans" in out:
        out["trans"] = np.zeros_like(traj["trans"])
    R, T = np.asarray(DEFAULT_R, np.float32), np.asarray(DEFAULT_T, np.float32)
    if "view_fov" in traj:
        V = traj["view_fov"].shape[1]
        rots = np.stack([Rotation.from_rotvec([0, a, 0]).as_matrix() @ R
                         for a in np.linspace(0, np.pi / 2, V)]).astype(np.float32)
        out["view_cam_rot"] = np.ascontiguousarray(np.broadcast_to(rots, (n, V, 3, 3)))
        out["view_cam_trans"] = np.tile(T, (n, V, 1))
        out["view_fov"] = np.tile(np.linspace(50, 60, V, dtype=np.float32), (n, 1))
    else:
        out["cam_rot"] = np.tile(R, (n, 1, 1))
        out["cam_trans"] = np.tile(T, (n, 1))
        out["fov"] = np.linspace(50, 60, n, dtype=np.float32)
    return out


def _frame_cameras(monkeypatch):
    for cls in (janim.PredictionSmoother, tanim.PredictionSmoother):
        real = cls.smooth_params
        monkeypatch.setattr(cls, "smooth_params",
                            lambda self, params, keys=None, real=real: _framed(
                                real(self, params, keys)))


def _same_videos(tcaught, jcaught, n_frames):
    assert sorted(os.path.basename(p) for p in tcaught) == sorted(
        os.path.basename(p) for p in jcaught)
    by_name = {os.path.basename(p): f for p, f in jcaught.items()}
    for path, frames in tcaught.items():
        jframes = by_name[os.path.basename(path)]
        assert len(frames) == len(jframes) == n_frames
        for a, b in zip(frames, jframes):
            assert a.shape == b.shape and a.dtype == np.uint8
            assert (a.min(-1) < 200).mean() > 0.02          # the mesh is in view
            assert (np.abs(a.astype(int) - b.astype(int)).max(-1) > LEVELS).mean() <= EDGE_SHARE
        got, count = _read_back(path)
        assert len(got) == count == n_frames and got[0].shape == frames[0].shape


def test_singleview_run_inference_video_matches_jax(monkeypatch, tmp_path, toy):
    from smilify_tpu.cli.run_inference import main as j_run_inference

    spec, pkl = toy
    folder, _ = write_replicant_sequence(str(tmp_path / "seq"), spec, 5, RES, layout="unreal")
    _checkpoints(tmp_path, pkl, "single_view")
    jcaught, tcaught = _catch(monkeypatch, jexport), _catch(monkeypatch, texport)
    _frame_cameras(monkeypatch)
    common = ["--data-path", folder, "--batch-size", "2", "--smooth-window", "3"]
    j_run_inference(["--checkpoint", str(tmp_path / "jax" / "final_model"),
                     "--video", str(tmp_path / "jv" / "out.avi")] + common)
    (tmp_path / "tv").mkdir()
    t_run_inference.main(["--checkpoint", str(tmp_path / "port" / "final_model"),
                          "--video", str(tmp_path / "tv" / "out.avi"), "--device", "cpu"] + common)
    _same_videos(tcaught, jcaught, 5)
    # no --render-dir: the frames go to the config's visualizations_dir beside the checkpoint
    assert sorted(os.listdir(tmp_path / "port" / "visualizations")) == [
        f"frame_{i:05d}.png" for i in range(5)]


def test_multiview_run_inference_video_matches_jax(monkeypatch, tmp_path, toy):
    pytest.importorskip("h5py")
    from smilify_tpu.cli.run_inference import main as j_run_inference
    from smilify_tpu_torch.data.synthetic import generate_synthetic_multiview

    spec, pkl = toy
    store = generate_synthetic_multiview(spec, str(tmp_path / "mv.h5"), n_samples=3, n_views=3,
                                         resolution=RES, device="cpu")
    _checkpoints(tmp_path, pkl, "multi_view")
    jcaught, tcaught = _catch(monkeypatch, jexport), _catch(monkeypatch, texport)
    _frame_cameras(monkeypatch)
    (tmp_path / "jv").mkdir()
    (tmp_path / "tv").mkdir()
    j_run_inference(["--checkpoint", str(tmp_path / "jax" / "final_model"), "--data-path", store,
                     "--smooth-window", "3", "--render-dir", str(tmp_path / "jf"), "--video", str(tmp_path / "jv" / "mv.avi")])
    t_run_inference.main(["--checkpoint", str(tmp_path / "port" / "final_model"), "--data-path",
                          store, "--smooth-window", "3", "--render-dir", str(tmp_path / "tf"),
                          "--video", str(tmp_path / "tv" / "mv.avi"), "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in tcaught) == [
        "mv.avi", "mv_view0.avi", "mv_view1.avi", "mv_view2.avi"]
    _same_videos(tcaught, jcaught, 3)
    assert sorted(os.listdir(tmp_path / "tf")) == sorted(os.listdir(tmp_path / "jf"))
