"""The port's launch wiring (smilify_tpu_torch.train.multihost) against the
JAX package's, and its collectives on 2 gloo CPU ranks.

* ``detect_multihost_env``: the JAX package's table of environments (SLURM,
  TPU pods, ``SMILIFY_MULTIHOST``) gives the same answers; torchrun's
  ``WORLD_SIZE`` > 1 with ``MASTER_ADDR`` takes the place of the JAX
  coordinator variables;
* ``local_batch_size`` and ``shard_dataset_for_process``: the JAX package's
  shares and indices, every process's shard of one length;
* on 2 ranks: ``globalize`` and ``allgather`` round trips over 1-D and 2-D
  layouts, ``all_gather_stack``, ``AllReduceSum``'s value and gradient,
  ``host_group``, ``rank_device`` and ``primary_only``.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json

import jax
import numpy as np
import pytest

from smilify_tpu.train import multihost as jmh

from smilify_tpu_torch.train import multihost as tmh
from tests._torch_dist import run_ranks

# the JAX package's table, each case with the answer both give
SHARED = [
    ({}, False),
    ({"SMILIFY_MULTIHOST": "1"}, True),
    ({"SMILIFY_MULTIHOST": "no"}, False),
    ({"SLURM_PROCID": "0"}, False),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, False),
    ({"SLURM_PROCID": "1", "SLURM_NTASKS": "4"}, True),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "x"}, False),
    ({"TPU_WORKER_ID": "0"}, False),
    ({"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0"}, False),
    ({"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1"}, True),
    ({"CLOUD_TPU_TASK_ID": "0", "TPU_WORKER_HOSTNAMES": "h0,h1,h2"}, True),
]
# torchrun's variables, which take the place of the JAX coordinator's
TORCHRUN = [
    ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2", "RANK": "0"}, True),
    ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "1", "RANK": "0"}, False),
    ({"WORLD_SIZE": "8"}, False),
    ({"MASTER_ADDR": "10.0.0.1"}, False),
]


@pytest.mark.parametrize("env,want", SHARED)
def test_detect_multihost_env_matches_jax(env, want):
    assert jmh.detect_multihost_env(env) is want
    assert tmh.detect_multihost_env(env) is want


@pytest.mark.parametrize("env,want", TORCHRUN)
def test_detect_multihost_env_torchrun(env, want):
    assert tmh.detect_multihost_env(env) is want
    assert not tmh.maybe_initialize_multihost(False, environ={"WORLD_SIZE": "1"})


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("global_bs", [1, 4, 7, 32])
def test_local_batch_size_matches_jax(n, global_bs):
    assert tmh.local_batch_size(global_bs, n) == jmh.local_batch_size(global_bs, n)


@pytest.mark.parametrize("n_samples,n_proc", [(10, 3), (9, 3), (5, 4), (17, 4)])
def test_shard_dataset_for_process_matches_jax(monkeypatch, n_samples, n_proc):
    dataset = list(range(n_samples))
    lengths = []
    for pi in range(n_proc):
        monkeypatch.setattr(tmh, "process_index", lambda pi=pi: pi)
        monkeypatch.setattr(tmh, "process_count", lambda: n_proc)
        monkeypatch.setattr(jax, "process_index", lambda pi=pi: pi)
        monkeypatch.setattr(jax, "process_count", lambda: n_proc)
        tbs, tlocal = tmh.shard_dataset_for_process(dataset, 8)
        jbs, jlocal = jmh.shard_dataset_for_process(dataset, 8)
        assert tbs == jbs
        assert [tlocal[i] for i in range(len(tlocal))] == [jlocal[i] for i in range(len(jlocal))]
        lengths.append(len(tlocal))
    assert len(set(lengths)) == 1


BODY = r'''
import json
import numpy as np
from smilify_tpu_torch.fitter.fitter import FitParams
from smilify_tpu_torch.train import multihost as mh

work = sys.argv[1]
out = {"rank": RANK, "primary": mh.is_primary(), "index": mh.process_index(),
       "count": mh.process_count(), "device": str(mh.rank_device("cpu")),
       "backend": dist.get_backend()}
mesh1 = mh.make_mesh((2,), ("frames",), "cpu")
mesh2 = mh.make_mesh((2, 1), ("clips", "frames"), "cpu")
full = {"a": torch.arange(24.0).reshape(4, 6), "b": torch.arange(6.0), "c": None}
specs = {"a": ("frames", None), "b": None, "c": None}
local = mh.globalize(full, mesh1, specs)
out["local_a"] = local["a"].tolist()
back = mh.allgather(local, mesh1, specs)
out["round_trip"] = bool(np.array_equal(back["a"], full["a"].numpy())
                         and np.array_equal(back["b"], full["b"].numpy()) and back["c"] is None)
params = FitParams(**{k: torch.full((4, 2, 3), float(i)) for i, k in enumerate(FitParams.fields())})
tile = FitParams(**{k: ("clips", "frames") for k in FitParams.fields()})
lp = mh.globalize(params, mesh2, tile)
out["tile_shape"] = list(lp.trans.shape)
gp = mh.allgather(lp, mesh2, tile)
out["tile_round_trip"] = all(np.array_equal(getattr(gp, k), getattr(params, k).numpy())
                             for k in FitParams.fields())
out["stack"] = mh.all_gather_stack(torch.tensor([float(RANK), 10.0 + RANK])).tolist()
x = torch.tensor([1.0 + RANK, 2.0], requires_grad=True)
y = mh.AllReduceSum.apply(x * (RANK + 1), None)
(y * torch.tensor([1.0, 3.0])).sum().backward()
out["allreduce"] = y.tolist()
out["allreduce_grad"] = x.grad.tolist()
out["host_group_is_group"] = mh.host_group(mesh1.get_group("frames")) is mesh1.get_group("frames")
out["primary_only"] = mh.primary_only(lambda: 7)()
with open(os.path.join(work, f"out_{RANK}.json"), "w") as f:
    json.dump(out, f)
'''


def test_collectives_on_two_ranks(tmp_path):
    run_ranks(2, BODY, tmp_path, args=[tmp_path], timeout=300)
    outs = [json.loads((tmp_path / f"out_{r}.json").read_text()) for r in range(2)]
    for r, out in enumerate(outs):
        assert (out["primary"], out["index"], out["count"]) == (r == 0, r, 2)
        assert out["device"] == "cpu" and out["backend"] == "gloo"
        assert out["local_a"] == np.arange(24.0).reshape(4, 6)[2 * r:2 * r + 2].tolist()
        assert out["round_trip"] and out["tile_round_trip"] and out["tile_shape"] == [2, 2, 3]
        assert out["stack"] == [[0.0, 10.0], [1.0, 11.0]]
        # Σ_r (1 + r)·(x_r) with x = (1 + r, 2): (1·1 + 2·2, 1·2 + 2·2)
        assert out["allreduce"] == [5.0, 6.0]
        # d/dx_r of Σ_r' (w · y) with w = (1, 3) summed on every rank: 2·(r + 1)·w
        assert out["allreduce_grad"] == [2.0 * (r + 1), 6.0 * (r + 1)]
        assert out["host_group_is_group"]
        assert out["primary_only"] == (7 if r == 0 else None)
