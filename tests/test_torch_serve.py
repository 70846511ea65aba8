"""The port's serving export (smilify_tpu_torch.serve, cli/export_serving)
held to the live model and to the JAX package's artifact on the CPU.

Checkpoints: seeded ``unet_micro`` variables at 32² as an orbax checkpoint
for the JAX package and the port's checkpoint converted from them with
``weight_port.state_dict_from_flax`` (``tests/test_torch_inference.py``).

* the round trip, single- and multi-view: the artifact's outputs within
  1e-5 of the live model's (``build_predict_fn``), the JAX package's
  round-trip gate;
* one symbolic-batch artifact serves B=1, 3 and 5;
* the port's artifact against the JAX package's on the carried weights,
  within the float32 serving gate of the models' tests (2e-5 × max(1,
  max |JAX|), ``tests/test_torch_models.py::MODEL_TOL``);
* the sidecar's keys are the JAX sidecar's, ``jax_version`` read as
  ``torch_version``;
* ``export_serving --verify``;
* ``shard_data`` over two CPU replicas: a batch of 4 split 2 + 2 and joined;
* a fresh process that imports only ``torch`` and ``smilify_tpu_torch.serve``
  loads and serves the artifact without importing the model code.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu_torch import serve
from smilify_tpu_torch.cli import export_serving
from smilify_tpu_torch.cli.run_inference import load_model_from_checkpoint
from tests.test_torch_inference import RES, _checkpoints
from tests.test_torch_models import MODEL_TOL, assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's round-trip gate (tests/test_serving_export.py): the
# exported program may order a few float sums unlike the eager model
ROUND_TRIP_ATOL = 1e-5


def _inputs(mode, batch, n_views=3, seed=0):
    rng = np.random.RandomState(seed)
    if mode == "multi_view":
        mask = np.ones((batch, n_views), bool)
        mask[0, -1] = False
        return (rng.rand(batch, n_views, RES, RES, 3).astype(np.float32), mask,
                np.tile(np.arange(n_views, dtype=np.int32), (batch, 1)))
    return (rng.rand(batch, RES, RES, 3).astype(np.float32),)


def _live(ckpt, inputs):
    model, cfg, rcfg, spec, _ = load_model_from_checkpoint(ckpt, device="cpu")
    with torch.no_grad():
        return serve.build_predict_fn(model, rcfg, spec, cfg.mode == "multi_view")(
            *(torch.from_numpy(a) for a in inputs))


@pytest.fixture(scope="module", params=["single_view", "multi_view"])
def exported(request, tmp_path_factory):
    """(mode, root, port artifact with a symbolic batch)."""
    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.tools.synthetic_data import write_model_pkl

    mode = request.param
    root = tmp_path_factory.mktemp(mode)
    pkl = write_model_pkl(str(root / "toy.pkl"), toy_model_spec(8, 6, 3, device="cpu"))
    _checkpoints(root, pkl, mode)
    art = str(root / "port.pt2z")
    meta = serve.export_serving_artifact(str(root / "port" / "final_model"), art,
                                         platforms=("cpu",))
    assert meta["batch_size"] == "symbolic" and meta["mode"] == mode
    return mode, root, art


def test_round_trip_serves_b1_3_5_from_one_artifact(exported):
    mode, root, art = exported
    served = serve.load_serving_artifact(art, "cpu")
    assert served.devices == [torch.device("cpu")]
    for batch in (1, 3, 5):
        inputs = _inputs(mode, batch, seed=batch)
        got = served(*inputs)
        want = _live(str(root / "port" / "final_model"), inputs)
        assert sorted(got) == sorted(want) and got["global_rot"].shape[0] == batch
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=ROUND_TRIP_ATOL,
                                       err_msg=f"B={batch} {k}")


def test_artifact_matches_the_jax_artifact(exported):
    from smilify_tpu.serve import export_serving_artifact as j_export
    from smilify_tpu.serve import load_serving_artifact as j_load

    mode, root, art = exported
    jart = str(root / "jax.jaxexport")
    jmeta = j_export(str(root / "jax" / "final_model"), jart, batch_size=0, platforms=("cpu",))
    inputs = _inputs(mode, 3, seed=7)
    want = j_load(jart)(*(jnp.asarray(a) for a in inputs))
    got = serve.load_serving_artifact(art, "cpu")(*inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], np.asarray(want[k]), MODEL_TOL, k)
    with open(art + ".json") as f:
        sidecar = json.load(f)
    assert set(sidecar) == (set(jmeta) - {"jax_version"}) | {"torch_version"}
    assert sidecar["output_keys"] == jmeta["output_keys"]
    assert sidecar["n_views"] == jmeta["n_views"] and sidecar["batch_size"] == "symbolic"


def test_export_serving_cli_verifies(exported, tmp_path):
    mode, root, _ = exported
    out = str(tmp_path / "cli.pt2z")
    meta = export_serving.main(["--checkpoint", str(root / "port" / "final_model"), "--output",
                                out, "--batch", "2", "--platforms", "cpu", "--verify"])
    assert meta["batch_size"] == 2 and meta["verify_max_abs"] <= export_serving.VERIFY_ATOL
    assert os.path.getsize(out) == meta["artifact_bytes"]


def test_shard_data_over_two_cpu_replicas(exported, tmp_path):
    mode, root, _ = exported
    out = str(tmp_path / "sharded.pt2z")
    meta = serve.export_serving_artifact(str(root / "port" / "final_model"), out, batch_size=4,
                                         platforms=("cpu",), shard_data=True, n_devices=2)
    assert meta["data_sharded"] and meta["n_devices"] == 2
    served = serve.load_serving_artifact(out, "cpu")
    assert len(served.devices) == 2
    inputs = _inputs(mode, 4, seed=11)
    got, want = served(*inputs), _live(str(root / "port" / "final_model"), inputs)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=ROUND_TRIP_ATOL,
                                   err_msg=k)
    with pytest.raises(ValueError):
        serve.export_serving_artifact(str(root / "port" / "final_model"), out, batch_size=3,
                                      platforms=("cpu",), shard_data=True, n_devices=2)


def test_loads_in_a_process_without_model_code(exported, tmp_path):
    mode, root, art = exported
    inputs = _inputs(mode, 2, seed=5)
    np.savez(tmp_path / "inputs.npz", *inputs)
    code = (
        "import sys, numpy as np, torch\n"
        "import smilify_tpu_torch.serve as serve\n"
        f"m = serve.load_serving_artifact({art!r}, 'cpu')\n"
        f"z = np.load({str(tmp_path / 'inputs.npz')!r})\n"
        "out = m(*[z[f'arr_{i}'] for i in range(len(z.files))])\n"
        f"np.savez({str(tmp_path / 'served.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})\n"
        "loaded = sorted(n for n in sys.modules if n.startswith('smilify_tpu'))\n"
        "assert loaded == ['smilify_tpu_torch', 'smilify_tpu_torch.serve'], loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)
    got = dict(np.load(tmp_path / "served.npz"))
    want = _live(str(root / "port" / "final_model"), inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=0, atol=ROUND_TRIP_ATOL,
                                   err_msg=k)
