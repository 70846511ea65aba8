"""The port's sharded fitters over gloo CPU ranks, held to the JAX package's
unsharded fits.

One launch of 2 ranks and one of 4 (``tests/_torch_dist.py``) run:

* ``ShardedSequenceFitter`` on N=8 frames at 64² (the JAX test's two-stage
  schedule, chunk 2: the halo pairs cross 1 and 3 rank boundaries);
* ``ShardedBatchedFitter`` on 4 clips × 2 frames (2 and 4 clip ranks) and,
  on 4 ranks, ``GridShardedFitter`` on a 2 × 2 mesh of 2 clips × 4 frames;
* ``ShardedStageManager`` on 4 targets: the sampling-free stages of
  ``tests/test_torch_registration.py`` against the JAX ``StageManager``,
  and a chamfer stage (the samples drawn) against the port's unsharded
  manager, which draws from the same seeded generator;
* on 2 ranks, ``temporal_losses_halo``'s value and gradient against JAX's
  ``temporal_losses`` on the whole sequence; ``optimize_to_joints
  --shard-frames`` on a 4-frame BADJA-layout sequence, ``optimize_corpus
  --shard`` on 3 replicAnt clips and ``optimise_3d``'s ``register(shard=True)``
  on 3 scans, each against its run in one process.

The ranks' results are gathered (``gathered_params``, the all-reduced
trajectory) and compared here with the JAX package's unsharded fits at the
JAX tests' gates (``tests/test_fitter_frames.py``, ``test_fitter_batch.py``,
``test_fitter3d.py``): loss trajectory rtol 1e-3 (registration 1e-4), end
parameters 3e-3. The targets are the JAX package's ``synthetic_fit_data``
renders (reachable poses, as every port fitter test uses), not the JAX
tests' noise silhouettes: on noise a few gradients (the leaf joint's twist)
are rounding noise that Adam turns into ±lr steps, so two float programs
(XLA's and the port's) part by ~2·lr there whatever the sharding. The CLI is
held to its single-process run at the CPU CLI test's 1e-4.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smilify_tpu.fitter import fitter as jfit
from smilify_tpu.fitter import fitter3d as J3
from smilify_tpu.fitter import fitter_batch as jbatch
from smilify_tpu.fitter.stages import StageWeights as JStageWeights
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from tests._torch_dist import run_ranks

H = W = 64
N = 8
TRAJ_RTOL, TRAJ_ATOL, PARAM_TOL = 1e-3, 1e-6, 3e-3
REG_RTOL, REG_ATOL = 1e-4, 1e-7
SCHEDULE = [
    dict(num_iters=3, lr=1e-2, w_j2d=1.0, w_reproj=0.0, w_betas=0.0,
         w_pose=0.0, w_limit=0.0, w_splay=0.0, w_temp=0.0),
    dict(num_iters=4, lr=1e-2, w_j2d=1.0, w_reproj=0.5, w_betas=0.1,
         w_pose=0.01, w_limit=0.01, w_splay=0.01, w_temp=0.5),
]
FIELDS = ("global_rot", "joint_rot", "betas", "trans", "fov", "log_beta_scales", "joint_trans")
REG_FIELDS = ("global_rot", "joint_rot", "betas", "trans", "log_beta_scales", "betas_trans",
              "deform_verts")
N_TARGETS = 4

BODY = r'''
import json, pickle
import numpy as np
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter3d as T3
from smilify_tpu_torch.fitter.fitter import FitData, FitParams, SmalFitter
from smilify_tpu_torch.fitter.fitter_batch import GridShardedFitter, ShardedBatchedFitter
from smilify_tpu_torch.fitter.fitter_frames import ShardedSequenceFitter, temporal_losses_halo
from smilify_tpu_torch.fitter.stages import StageWeights
from smilify_tpu_torch.train.multihost import all_gather_stack, all_reduce_sum, axis_group, make_mesh

work = sys.argv[1]
inp = dict(np.load(os.path.join(work, "inputs.npz")))
spec = toy_model_spec(device="cpu")
schedule = [StageWeights(**w) for w in json.loads(open(os.path.join(work, "schedule.json")).read())]
out = {}

def data_of(prefix):
    return FitData(rgb=None, **{k: torch.from_numpy(inp[f"{prefix}_{k}"])
                                for k in ("sil", "joints", "visibility")})

def fit(fitter, chunk=2):
    traj = []
    fitter.fit(schedule=schedule, chunk=chunk, callback=lambda s, i, l, o: traj.append(float(l)))
    return np.asarray(traj), fitter.gathered_params()

def keep(name, traj, params):
    out[f"{name}_traj"] = traj
    for k in FitParams.fields():
        out[f"{name}_{k}"] = getattr(params, k).numpy()

keep("seq", *fit(ShardedSequenceFitter(spec, data_of("seq"), (64, 64), device="cpu")))
keep("clips", *fit(ShardedBatchedFitter(spec, data_of("clips"), (64, 64), device="cpu")))
if WORLD == 4:
    mesh = make_mesh((2, 2), ("clips", "frames"), "cpu")
    keep("grid", *fit(GridShardedFitter(spec, data_of("grid"), (64, 64), mesh=mesh, device="cpu")))

# registration: the sampling-free stages (held to JAX), then a chamfer stage
# (held to the unsharded port manager, which draws the same samples)
meshes = [(inp[f"target{i}_verts"], inp[f"target{i}_faces"]) for i in range(int(inp["n_targets"]))]
targets = T3.pad_target_meshes(meshes, [f"t{i}" for i in range(len(meshes))], device="cpu")
start = T3.fit3d_params_from_numpy({k: inp[f"reg_{k}"] for k in T3.Fit3DParams.fields()}, device="cpu")
lw = {"chamfer": 0.0, "edge": 1.0, "normal": 0.01, "laplacian": 0.1, "sdf": 0.0}
def stages():
    return [T3.Stage("s0", "deform", n_its=3, lr=0.01, loss_weights=lw),
            T3.Stage("s1", "default", n_its=3, lr=0.01, loss_weights=lw,
                     custom_lrs={"global_rot": 1e-6, "trans": 1e-6, "joint_rot": 0.005})]
def chamfer_stage():
    return T3.Stage("c", "init", n_its=6, lr=0.05, num_samples=500,
                    loss_weights={"chamfer": 1.0, "edge": 0.0, "normal": 0.0, "laplacian": 0.0,
                                  "sdf": 0.0})
for name, make, plain in (("reg", stages, False), ("chamfer", lambda: [chamfer_stage()], True)):
    mgr = T3.ShardedStageManager(spec, targets, params=start, seed=0)
    for st in make():
        mgr.add_stage(st)
    traj = []
    mgr.run(callback=lambda s, i, l, o: traj.append(float(l)), chunk=2)
    full = mgr.gathered_params()
    out[f"{name}_traj"] = np.asarray(traj)
    for k in T3.Fit3DParams.fields():
        out[f"{name}_{k}"] = getattr(full, k).numpy()
    if plain and RANK == 0:
        ref = T3.StageManager(spec, targets, params=start, seed=0)
        for st in make():
            ref.add_stage(st)
        rtraj = []
        ref.run(callback=lambda s, i, l, o: rtraj.append(float(l)))
        out[f"{name}_plain_traj"] = np.asarray(rtraj)
        for k in T3.Fit3DParams.fields():
            out[f"{name}_plain_{k}"] = getattr(ref.params, k).numpy()

if WORLD == 2:
    # the halo alone: value and gradient on random parameters
    group, D, r = axis_group(make_mesh((2,), ("frames",), "cpu"), "frames")
    n = int(inp["halo_global_rot"].shape[0]) // D
    local = FitParams(**{k: torch.from_numpy(inp[f"halo_{k}"][r * n:(r + 1) * n]
                                             if k in ("global_rot", "joint_rot", "trans", "fov")
                                             else inp[f"halo_{k}"]).requires_grad_(True)
                         for k in FitParams.fields()})
    terms = temporal_losses_halo(local, 0.7, group, D, r)
    sum(terms).backward()
    out["halo_value"] = all_reduce_sum(torch.stack([t.detach() for t in terms]), group).numpy()
    for k in ("joint_rot", "global_rot", "trans"):
        out[f"halo_grad_{k}"] = torch.cat(list(all_gather_stack(getattr(local, k).grad,
                                                                group))).numpy()

    # optimise_3d's body over the two ranks: 3 scans, padded to 4
    import glob
    from smilify_tpu_torch.cli.optimise_3d import register
    register(spec, sorted(glob.glob(os.path.join(work, "scans", "*.obj"))), [chamfer_stage()],
             os.path.join(work, "register_sharded"), batch_size=-1, num_samples=500, chunk=2,
             shard=True)

    # the CLIs over the two ranks
    from smilify_tpu_torch.cli import optimize_corpus, optimize_to_joints
    optimize_to_joints.main(json.loads(open(os.path.join(work, "cli_args.json")).read())
                            + ["--shard-frames", "--device", "cpu",
                               "--output-dir", os.path.join(work, "cli_sharded")])
    optimize_corpus.main(json.loads(open(os.path.join(work, "corpus_args.json")).read())
                         + ["--shard", "--device", "cpu",
                            "--output-dir", os.path.join(work, "corpus_sharded")])

if RANK == 0:
    np.savez(os.path.join(work, f"out_{WORLD}.npz"), **out)
'''


def _jax_data(n_frames, seed):
    """The JAX package's reachable targets (64², the toy spec), with a fifth
    of the limb joints hidden. The torso joints stay visible: stage 0 sees
    only them, and a frame without one has no stage-0 gradient at all (its
    fov, at lr 1, would take Adam's ±lr step on rounding noise)."""
    jspec = jax_toy_spec()
    d = jfit.synthetic_fit_data(jspec, n_frames, (H, W), seed=seed, use_pallas=False)
    vis = np.asarray(d.visibility).copy()
    hide = np.random.RandomState(seed).rand(*vis.shape) < 0.2
    hide[:, list(jspec.torso_joints)] = False
    vis[hide] = 0.0
    return {"sil": np.asarray(d.sil), "joints": np.asarray(d.joints), "visibility": vis}


def _jax_fit(fitter):
    traj = []
    fitter.fit(schedule=[JStageWeights(**w) for w in SCHEDULE],
               callback=lambda st, it, loss, objs: traj.append(float(loss)))
    return np.asarray(traj), {k: np.asarray(getattr(fitter.params, k)) for k in FIELDS}


def _targets(jspec):
    """Four target meshes: the template scaled and shifted, fewer faces each."""
    rng = np.random.RandomState(0)
    v0 = np.asarray(jspec.v_template)
    faces = np.asarray(jspec.faces)
    return [((v0 * (1.0 + 0.1 * i) + rng.randn(3) * 0.05).astype(np.float32),
             faces[: len(faces) - 4 * i]) for i in range(N_TARGETS)]


def _reg_start(jspec):
    rng = np.random.RandomState(21)
    J, P, V = jspec.n_joints, jspec.n_joints - 1, jspec.n_verts
    B = N_TARGETS
    return {k: v.astype(np.float32) for k, v in {
        "global_rot": rng.uniform(-0.2, 0.2, (B, 3)),
        "joint_rot": rng.uniform(-0.1, 0.1, (B, P, 3)),
        "betas": rng.uniform(-0.3, 0.3, (B, jspec.n_betas)),
        "trans": rng.uniform(-0.05, 0.05, (B, 3)),
        "log_beta_scales": rng.uniform(-0.1, 0.1, (B, J, 3)),
        "betas_trans": rng.uniform(-0.02, 0.02, (B, J, 3)),
        "deform_verts": rng.uniform(-0.005, 0.005, (B, V, 3))}.items()}


def _write_badja(root, n_frames=4):
    """A BADJA-layout sequence of the port's toy model posed and rendered at
    48² (reachable targets), joints in (row, col)."""
    import torch

    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter import synthetic_fit_data
    from smilify_tpu_torch.utils.image_io import write_png

    spec = toy_model_spec(device="cpu")
    d = synthetic_fit_data(spec, n_frames, (48, 48), seed=5)
    os.makedirs(root / "joint_annotations")
    os.makedirs(root / "img")
    rng = np.random.RandomState(5)
    seq = []
    for i in range(n_frames):
        write_png(root / "img" / f"{i}.png", rng.randint(0, 256, (48, 48, 3)).astype(np.uint8))
        seg = (d.sil[i].numpy()[..., None] * 255).astype(np.uint8).repeat(3, axis=-1)
        write_png(root / "img" / f"{i}_seg.png", seg)
        seq.append({"image_path": f"img/{i}.png", "segmentation_path": f"img/{i}_seg.png",
                    "joints": d.joints[i].numpy().tolist(), "visibility": [1] * spec.n_joints})
    (root / "joint_annotations" / "toy.json").write_text(json.dumps(seq))
    assert float(torch.as_tensor(d.sil).mean()) > 0.01
    return spec


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Inputs for the ranks, and the JAX package's unsharded references."""
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    root = tmp_path_factory.mktemp("sharded")
    jspec = jax_toy_spec()
    seq, frames = _jax_data(N, 42), _jax_data(8, 7)
    clips = {k: v.reshape((4, 2) + v.shape[1:]) for k, v in frames.items()}
    grid = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in frames.items()}
    rng = np.random.RandomState(0)
    P = jspec.n_joints - 1
    halo = {"global_rot": rng.randn(N, 3), "joint_rot": rng.randn(N, P, 3),
            "betas": rng.randn(jspec.n_betas), "trans": rng.randn(N, 3),
            "fov": np.full((N,), 60.0), "log_beta_scales": np.zeros((jspec.n_joints, 3)),
            "joint_trans": np.zeros((jspec.n_joints, 3))}
    halo = {k: v.astype(np.float32) for k, v in halo.items()}
    inputs = {f"{p}_{k}": v for p, d in (("seq", seq), ("clips", clips), ("grid", grid))
              for k, v in d.items()}
    inputs.update({f"halo_{k}": v for k, v in halo.items()})
    targets = _targets(jspec)
    for i, (v, f) in enumerate(targets):
        inputs[f"target{i}_verts"], inputs[f"target{i}_faces"] = v, f.astype(np.int64)
    inputs["n_targets"] = np.asarray(N_TARGETS)
    start = _reg_start(jspec)
    inputs.update({f"reg_{k}": v for k, v in start.items()})
    np.savez(root / "inputs.npz", **inputs)
    (root / "schedule.json").write_text(json.dumps(SCHEDULE))

    # optimise_3d's scans and its single-process run (the chamfer stage of BODY)
    from smilify_tpu_torch.cli.optimise_3d import register
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.fitter.fitter3d import Stage
    from smilify_tpu_torch.utils.export import save_obj

    os.makedirs(root / "scans")
    for i, (v, f) in enumerate(targets[:3]):
        save_obj(str(root / "scans" / f"scan{i}.obj"), v, f)
    # the sharded run pads its 3 scans to 4 by repeating the first: the run
    # in one process gets the same 4, so both draw the same samples
    register(toy_model_spec(device="cpu"), [str(root / "scans" / f"scan{i}.obj") for i in (0, 1, 2, 0)],
             [Stage("c", "init", n_its=6, lr=0.05, num_samples=500, loss_weights={
                 "chamfer": 1.0, "edge": 0.0, "normal": 0.0, "laplacian": 0.0, "sdf": 0.0})],
             str(root / "register_plain"), batch_size=-1, num_samples=500, chunk=2)

    # the CLI's sequence and its single-process run
    from smilify_tpu_torch.cli import optimize_to_joints

    spec = _write_badja(root / "badja")
    cli_args = ["--model", write_model_pkl(str(root / "toy.pkl"), spec),
                "--data-root", str(root / "badja"), "--sequence", "badja:toy",
                "--crop-size", "48", "--test", "--test-stages", "2", "--exact",
                "--iter-chunk", "4"]
    (root / "cli_args.json").write_text(json.dumps(cli_args))
    optimize_to_joints.main(cli_args + ["--device", "cpu", "--output-dir", str(root / "cli_plain")])

    # the corpus CLI: 3 one-frame clips (padded to 4 on 2 ranks) and its run in one process
    from smilify_tpu_torch.cli import optimize_corpus
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence

    coco, _ = write_replicant_sequence(str(root / "replicant"), spec, 3, 48)
    corpus_args = ["--model", cli_args[1], "--data-root", coco, "--all-replicant", "--test",
                   "--test-stages", "2", "--exact", "--iter-chunk", "4"]
    (root / "corpus_args.json").write_text(json.dumps(corpus_args))
    optimize_corpus.main(corpus_args + ["--device", "cpu", "--output-dir", str(root / "corpus_plain")])

    refs = {"seq": _jax_fit(jfit.SmalFitter(jspec, jfit.FitData(
        rgb=None, **{k: jnp.asarray(v) for k, v in seq.items()}), (H, W), use_pallas=False))}
    for name, d in (("clips", clips), ("grid", grid)):
        refs[name] = _jax_fit(jbatch.BatchedFitter(jspec, jfit.FitData(
            rgb=None, **{k: jnp.asarray(v) for k, v in d.items()}), (H, W), use_pallas=False))
    jt = J3.pad_target_meshes([(v, f) for v, f in targets], [f"t{i}" for i in range(N_TARGETS)])
    jm = J3.StageManager(jspec, jt, J3.Fit3DParams(**{k: jnp.asarray(v) for k, v in start.items()}))
    lw = {"chamfer": 0.0, "edge": 1.0, "normal": 0.01, "laplacian": 0.1, "sdf": 0.0}
    jm.add_stage(J3.Stage("s0", "deform", n_its=3, lr=0.01, loss_weights=lw))
    jm.add_stage(J3.Stage("s1", "default", n_its=3, lr=0.01, loss_weights=lw,
                          custom_lrs={"global_rot": 1e-6, "trans": 1e-6, "joint_rot": 0.005}))
    reg_traj = []
    jm.run(callback=lambda s, i, loss, o: reg_traj.append(float(loss)))
    refs["reg"] = (np.asarray(reg_traj), {k: np.asarray(getattr(jm.params, k)) for k in REG_FIELDS})
    jparams = jfit.FitParams(**{k: jnp.asarray(v) for k, v in halo.items()})
    refs["halo_value"] = np.asarray([float(v) for v in jfit.temporal_losses(jparams, 0.7)])
    refs["halo_grad"] = jax.grad(lambda p: sum(jfit.temporal_losses(p, 0.7)))(jparams)
    return root, refs


@pytest.fixture(scope="module")
def launched(work):
    """``get(world)``: the ranks' results of one launch of ``world`` ranks
    (made once a module)."""
    root, refs = work
    done = {}

    def get(world):
        if world not in done:
            run_ranks(world, BODY, root, args=[root], timeout=900)
            done[world] = dict(np.load(root / f"out_{world}.npz"))
        return done[world], refs

    return get


def _held(out, name, ref, fields, rtol, atol, param_tol):
    traj, params = ref
    np.testing.assert_allclose(out[f"{name}_traj"], traj, rtol=rtol, atol=atol,
                               err_msg=f"{name}: loss trajectory")
    for k in fields:
        np.testing.assert_allclose(out[f"{name}_{k}"], params[k], rtol=param_tol, atol=param_tol,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("world,name", [(2, "seq"), (2, "clips"), (4, "seq"), (4, "clips"),
                                        (4, "grid")])
def test_sharded_fits_match_jax_unsharded(launched, world, name):
    out, refs = launched(world)
    assert len(out[f"{name}_traj"]) == sum(w["num_iters"] for w in SCHEDULE)
    _held(out, name, refs[name], FIELDS, TRAJ_RTOL, TRAJ_ATOL, PARAM_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_registration_matches_jax_and_unsharded(launched, world):
    out, refs = launched(world)
    _held(out, "reg", refs["reg"], REG_FIELDS, REG_RTOL, REG_ATOL, PARAM_TOL)
    plain = (out["chamfer_plain_traj"], {k: out[f"chamfer_plain_{k}"] for k in REG_FIELDS})
    _held(out, "chamfer", plain, REG_FIELDS, REG_RTOL, REG_ATOL, PARAM_TOL)
    assert out["chamfer_traj"][-1] < out["chamfer_traj"][0]


def test_temporal_halo_matches_jax(launched):
    out, refs = launched(2)
    np.testing.assert_allclose(out["halo_value"], refs["halo_value"], rtol=1e-5)
    for k in ("joint_rot", "global_rot", "trans"):
        np.testing.assert_allclose(out[f"halo_grad_{k}"], np.asarray(getattr(refs["halo_grad"], k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cli,n_frames", [("cli", 4), ("corpus", 3)])
def test_fitter_clis_sharded_match_one_process(launched, work, cli, n_frames):
    """optimize_to_joints --shard-frames (4 frames, 2 a rank) and
    optimize_corpus --shard (3 clips padded to 4, the padding not exported)
    on 2 ranks against the same CLI in one process: every frame's final
    parameters within the CPU CLI test's 1e-4."""
    launched(2)
    root, _ = work
    frames = sorted(os.listdir(root / f"{cli}_plain"))
    assert len(frames) == n_frames and sorted(os.listdir(root / f"{cli}_sharded")) == frames
    for f in frames:
        with open(root / f"{cli}_plain" / f / "st10_ep0.pkl", "rb") as fh:
            want = pickle.load(fh)
        with open(root / f"{cli}_sharded" / f / "st10_ep0.pkl", "rb") as fh:
            got = pickle.load(fh)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=f"{f}: {k}")


def test_optimise_3d_shard_matches_one_process(launched, work):
    """register(shard=True) on 2 ranks: 3 scans padded to 4 (the first
    repeated), the repeat dropped from the npz that rank 0 writes, each scan
    fitted as in one process on the same 4 (the same draws)."""
    launched(2)
    root, _ = work
    got = dict(np.load(root / "register_sharded" / "batch_0" / "c.npz"))
    want = dict(np.load(root / "register_plain" / "batch_0" / "c.npz"))
    assert sorted(got) == sorted(want)
    assert list(got["labels"]) == ["scan0", "scan1", "scan2"]
    np.testing.assert_array_equal(got["faces"], want["faces"])
    for k in REG_FIELDS + ("verts", "joints"):
        assert got[k].shape[0] == 3 and want[k].shape[0] == 4
        np.testing.assert_allclose(got[k], want[k][:3], rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=k)
