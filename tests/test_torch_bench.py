"""The port's measurement path on the CPU: K5's plain version against the JAX
probe's body, the chain timer, the raster work count against the JAX
bench's, and the bench entry points run end to end at a tiny size.

The JAX probe is a closure inside ``tools/bench_all.py::measure_vpu_peak_gflops``
and cannot be imported, so its body is restated here in ``jnp`` from
``tools/bench_all.py:126-138``; likewise the JAX bench's work count from
``tools/bench_all.py:258-279``. K5's tolerance is rtol 1e-5: the plain
version rounds each round once, as the kernel's FMA does, and XLA may round
the multiply and the add apart (one rounding a round, 128 rounds). The key
sets of the JAX benches are read
from their sources.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import ast
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.core.lbs import smil_forward as jax_smil_forward
from smilify_tpu.fitter import fitter as jfit
from smilify_tpu.render import rasterizer as JR
from smilify_tpu.render.cameras import default_camera as jax_default_camera
from smilify_tpu.render.rasterizer_worklist import _tile_worklists as jax_tile_worklists
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec

from smilify_tpu_torch import bench
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter as tfit
from smilify_tpu_torch.fitter import stages as tstages
from smilify_tpu_torch.tools import _timing, bench_all, bench_corpus, bench_progressive, peak
from smilify_tpu_torch.utils import monitoring

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = 64


def _jax_probe(x):
    """tools/bench_all.py:126-138, the Pallas kernel's body, on a whole array."""
    streams, reps = 32, 128
    accs = tuple(x * (1.0 + 0.1 * i) for i in range(streams))

    def body(_, accs):
        return tuple(a * jnp.float32(0.999999) + jnp.float32(1e-9) for a in accs)

    accs = jax.lax.fori_loop(0, reps, body, accs)
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def test_fma_peak_plain_matches_jax_body():
    x = np.random.RandomState(0).uniform(0.25, 2.0, (16, 128)).astype(np.float32)
    want = np.asarray(jax.jit(_jax_probe)(jnp.asarray(x)))
    with monitoring.recording():
        launches = monitoring.summary()["counters"].get("peak.fma.launches", 0)
        got = peak.fma_peak(torch.from_numpy(x))       # a CPU tensor: the plain version
        assert monitoring.summary()["counters"].get("peak.fma.launches", 0) == launches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got.numpy(), peak.fma_peak_plain(torch.from_numpy(x)).numpy())
    assert peak.flops(x.size) == 32 * 2 * 128 * x.size


def test_fma_peak_plain_rounds_once_a_round():
    """Each round is rounded to float32 once, as one FMA rounds: the plain
    version equals a numpy float64 multiply-add rounded to float32 a round."""
    x = np.random.RandomState(1).uniform(0.25, 2.0, (8, 64)).astype(np.float32)
    mul, add = np.float64(np.float32(peak.MUL)), np.float64(np.float32(peak.ADD))
    a = [x * np.float32(1.0 + 0.1 * i) for i in range(peak.STREAMS)]
    for _ in range(peak.ROUNDS):
        a = [(ai.astype(np.float64) * mul + add).astype(np.float32) for ai in a]
    want = a[0]
    for ai in a[1:]:
        want = want + ai
    np.testing.assert_array_equal(peak.fma_peak_plain(torch.from_numpy(x)).numpy(), want)


def test_timeit_chain_windows_and_slope():
    calls = []

    def step(state):
        calls.append(None)
        time.sleep(0.002)
        return state + 1

    dt = _timing.timeit_chain(step, torch.zeros(3), n1=2, n2=6, warmup=1, repeats=3,
                              target_s=0.0)
    assert len(calls) == 1 + 2 + 3 * (2 + 6)       # warmup, probe, 3 pairs: no scaling
    assert 0.0015 < dt < 0.05
    calls.clear()
    _timing.timeit_chain(step, torch.zeros(3), n1=2, n2=6, warmup=1, repeats=1, target_s=0.1)
    assert len(calls) > 1 + 2 + 2 * (2 + 6)        # the probe scaled the windows up


def test_timeit_chain_redoes_a_stalled_pair(monkeypatch):
    """A stall in a pair's short window makes its slope negative: that pair
    is measured again, and no negative time comes back. The clock is a fake
    that each step advances, so no load on the host moves the windows."""
    calls = []
    clock = [0.0]

    def step(state):
        calls.append(None)
        clock[0] += 0.2 if len(calls) == 4 else 0.002   # the first pair's short window
        return state + 1

    monkeypatch.setattr(_timing.time, "perf_counter", lambda: clock[0])

    dt = _timing.timeit_chain(step, torch.zeros(3), n1=2, n2=6, warmup=1, repeats=1,
                              target_s=0.0)
    assert len(calls) == 1 + 2 + 2 * (2 + 6)       # warmup, probe, the stalled pair, its redo
    assert 0.0015 < dt < 0.05


def test_sync_finds_the_first_tensor():
    params = tfit.params_from_numpy({k: np.ones(2) for k in tfit.FitParams.fields()}, device="cpu")
    for state in (params, {"a": 1, "b": params}, (None, [torch.ones(1)]), torch.ones(2)):
        _timing.sync(state)
    with pytest.raises(TypeError, match="no tensor"):
        _timing.sync((1, "a"))


@pytest.fixture(scope="module")
def specs():
    return jax_toy_spec(10, 6, 3), toy_model_spec(10, 6, 3, device="cpu")


def _pose(spec, seed=31, n=2):
    rng = np.random.RandomState(seed)
    J, B = spec.n_joints, spec.n_betas
    g0 = jfit._default_global_rotation()
    return {
        "global_rot": (g0 + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32),
        "joint_rot": rng.uniform(-0.2, 0.2, (n, J - 1, 3)).astype(np.float32),
        "betas": rng.uniform(-0.3, 0.3, (B,)).astype(np.float32),
        "trans": rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32),
        "fov": np.full((n,), 60.0, np.float32),
        "log_beta_scales": np.zeros((J, 3), np.float32),
        "joint_trans": np.zeros((J, 3), np.float32),
    }


def _jax_active_groups(spec, params, H, W, approx_max_faces):
    """tools/bench_all.py:258-279, restated."""
    N = params.global_rot.shape[0]
    theta = jnp.concatenate([params.global_rot[:, None, :], params.joint_rot], axis=1)
    out = jax_smil_forward(spec, jnp.broadcast_to(params.betas, (N, spec.n_betas)), theta)
    cam = jax_default_camera()
    verts_w = out.verts + params.trans[:, None, :]
    pv = jax.vmap(cam.world_to_view)(verts_w)
    ndc = jax.vmap(cam.view_to_ndc)(pv)
    vb = jnp.concatenate([ndc[..., :2], pv[..., 2:3]], axis=-1)
    tri = vb[:, spec.faces]
    valid = jnp.any(tri[..., 2] > 0.0, axis=-1)
    if approx_max_faces is not None:
        k_sub = max(1, -(-approx_max_faces // JR.FACE_GROUP))
        _, count = jax_tile_worklists(tri[..., :2], tri[..., 2], valid, H, W, 1e-4, k_sub)
        return int(np.asarray(count).sum())
    mask = np.asarray(JR._tile_cull_mask(tri[..., :2], valid, H, W, 1e-4))
    return sum(bin(int(x)).count("1") for x in mask)


@pytest.mark.parametrize("cap", [None, 40, 800])
def test_active_subgroups_match_jax(specs, cap):
    jspec, tspec = specs
    p = _pose(tspec)
    want = _jax_active_groups(jspec, jfit.FitParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                              SIZE, SIZE, cap)
    got = bench_all.raster_active_subgroups(tspec, tfit.params_from_numpy(p, device="cpu"),
                                            (SIZE, SIZE), cap)
    assert got == want and got > 0


def _keys_in(path, func):
    """String keys of the dict literals and subscript stores in ``func`` of ``path``."""
    tree = ast.parse((REPO / path).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_bench_forward_runs_with_the_jax_keys(specs):
    res = bench_all.bench_forward(specs[1], repeats=1, target_s=0.0)
    assert set(res) == {f"b{b}_{k}" for b in (1, 64) for k in ("ms", "samples_per_sec")}
    assert all(np.isfinite(v) and v > 0 for v in res.values())


@pytest.mark.parametrize("frames, cap", [(1, None), (2, 40)])
def test_bench_fitter_step_runs_with_the_jax_keys(specs, frames, cap):
    res = bench_all.bench_fitter_step(specs[1], frames, cap, fp32_peak_gflops=1000.0, size=SIZE,
                                      repeats=1, target_s=0.0)
    jax_keys = _keys_in("tools/bench_all.py", "bench_fitter_step")
    peak_keys = {"vpu_peak_gflops_measured", "raster_work_bound_over_peak_pct"}
    assert peak_keys <= jax_keys
    assert jax_keys - peak_keys <= set(res)
    assert {"fp32_fma_peak_gflops_measured", "raster_work_bound_over_peak_pct"} <= set(res)
    assert res["frames"] == frames and res["image"] == f"{SIZE}x{SIZE}"
    assert res["raster_mode"] == ("exact" if cap is None else f"worklist_top{cap}")
    for k in ("step_ms", "chained10_step_ms", "raster_work_bound_gflops"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    # CPU tensors: the plain versions ran, no kernel launched
    assert res["kernel_launches"] == dict.fromkeys(res["kernel_launches"], 0)


def test_worklist_iou(specs):
    assert bench_all.measure_worklist_iou(specs[1], 800, SIZE) == 1.0   # no tile truncated
    assert 0.0 <= bench_all.measure_worklist_iou(specs[1], 8, SIZE) <= 1.0


def test_bench_all_main_merges_into_out(specs, monkeypatch, tmp_path):
    monkeypatch.setattr(bench_all, "load_spec", lambda model, dev: (specs[1], "toy"))
    seen = []
    monkeypatch.setattr(bench_all, "run", lambda spec, only, **kw: seen.append(only) or
                        {"config1_smil_forward_stick": {"b1_ms": 1.0}})
    out = tmp_path / "bench.json"
    out.write_text(json.dumps({"config9_kept": 1, "config1_smil_forward_stick": {}}))
    bench_all.main(["--only", "config1", "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert seen == [["config1"]]
    assert report["config9_kept"] == 1 and report["device"] == "cpu" and report["card"] is None
    assert report["config1_smil_forward_stick"] == {"b1_ms": 1.0}
    # without --only the file is replaced
    bench_all.main(["--device", "cpu", "--out", str(out)])
    assert "config9_kept" not in json.loads(out.read_text())


def test_bench_run_has_the_jax_keys(specs):
    res = bench.run(specs[1], "toy", (SIZE, SIZE), repeats=1, target_s=0.0)
    jax_keys = _keys_in("bench.py", "main") - {"measurement_change_r03"}
    assert jax_keys <= set(res)
    assert res["vs_baseline"] is None and res["raster_mode"] == "exact"   # no cap off the card
    assert res["value"] > 0 and res["single_dispatch_iters_per_sec"] > 0
    json.dumps(res)


def test_bench_corpus_run_has_the_jax_keys(specs):
    res = bench_corpus.run(specs[1], "toy", clips=2, size=SIZE, chunk=2)
    assert _keys_in("tools/bench_corpus.py", "main") <= set(res)
    assert res["backend"] == "cpu" and res["batched_step_ms"] > 0


def test_bench_progressive_run(specs):
    tspec = specs[1]
    data = tfit.synthetic_fit_data(tspec, 1, (SIZE, SIZE))
    for mode in ("fixed", "progressive"):
        wall, iou, kp = bench_progressive.run(mode, tspec, data, SIZE, 2, (1, 2),
                                                   tstages.test_schedule(2))
        assert wall > 0 and 0.0 <= iou <= 1.0 and np.isfinite(kp)


@pytest.mark.parametrize("backbone", ["resnet50", "resnet50_gn"])
def test_bench_singleview_train_step_has_the_jax_keys(specs, backbone):
    """configs 4b/4c on the CPU at a small size: the JAX bench's keys, and mfu."""
    res = bench_all.bench_singleview_train_step(specs[1], backbone, batches=(2,), res=32,
                                                repeats=1, target_s=0.0)
    # the keys of the JAX bench's result (tools/bench_all.py::bench_singleview_train_step) and mfu
    assert {"backbone", "resolution", "losses", "batch2_ms", "batch2_images_per_sec",
            "batch2_mfu", "mfu"} <= set(res) and res["backbone"] == backbone
    assert res["batch2_ms"] > 0 and res["batch2_images_per_sec"] > 0 and 0 < res["mfu"] < 1
    json.dumps(res)


def test_bench_multiview_train_step_has_the_jax_keys(specs):
    res = bench_all.bench_multiview_train_step(specs[1], batches=(1,), res=32, repeats=1,
                                               target_s=0.0)
    assert {"backbone", "resolution", "views", "losses", "batch1_ms", "batch1_frames_per_sec",
            "batch1_view_images_per_sec", "mfu"} <= set(res)
    assert res["batch1_view_images_per_sec"] == pytest.approx(4 * res["batch1_frames_per_sec"])


def test_input_pipeline_mode_runs_on_the_cpu(tmp_path, capsys):
    """One mode of the port's input-pipeline bench in this process, on a
    replicAnt folder it writes at 32²."""
    from smilify_tpu_torch.tools import bench_input_pipeline as bip

    pkl, folder = bip.write_data(tmp_path, 6, 32)
    for mode in ("synthetic", "cached_staged"):
        bip.main(["--mode", mode, "--data", folder, "--model-pkl", pkl, "--res", "32",
                  "--batch", "2", "--steps", "2", "--device", "cpu"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["mode"] == mode and rec["step_ms"] > 0 and rec["setup_s"] > 0
