"""The port's data-parallel train step over gloo CPU ranks, held to the JAX
package's single-device step.

One launch of 2 ranks (``tests/_torch_dist.py``) runs:

* ``train.multidevice.run_trainer_check`` (the multi-view regressor, a
  global batch of 4 in 2 micro-batches, the JAX harness's variables carried
  across with ``weight_port.state_dict_from_flax``): the 2-rank loss, eval
  loss, update norm and BatchNorm running statistics against the same step
  in one process (the harness's own gates: 2e-5, 2e-4, statistics 1e-6
  relative), and the loss against the JAX harness's single-device loss
  (1e-5 relative, ``tests/test_torch_train.py``'s loss gate);
* the same with each rank's BatchNorms on its own rows (DDP's default):
  the update and the running statistics leave their gates;
* ``train_epochs`` with a batch that fails to reach its device on rank 1:
  both ranks skip it, count one skip and one step, and end with equal
  weights (no hang: the launch has a time limit);
* one step whose batch holds a NaN on rank 1 only: the all-reduced gradient
  is non-finite on both ranks, so both skip the update;
* ``train_regressor --multihost`` from the device cache against the CLI in
  one process: the same epoch losses (1e-5) and final weights.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json

import pytest
import torch

from smilify_tpu.train import multidevice as jmd

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.models.weight_port import build_model, state_dict_from_flax
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_replicant_sequence
from smilify_tpu_torch.train import multidevice as tmd
from smilify_tpu_torch.train import trainer as ttrainer
from tests._torch_dist import run_ranks

LOSS_RTOL = 1e-5
RES = 32
TINY = ["model.backbone_name=unet_micro", f"model.input_resolution={RES}", "training.batch_size=4",
        "model.transformer_depth=1", "model.transformer_heads=2", "model.transformer_dim_head=8",
        "model.transformer_mlp_dim=16", "model.freeze_backbone=false", "training.num_workers=0",
        "training.use_mixed_precision=false", "dataset.dataset_fraction=1.0",
        "augmentation.enabled=false", "model.transformer_dropout=0.0",
        "training.device_data_cache=true", "dataset.train_ratio=0.5", "dataset.val_ratio=0.35",
        "dataset.test_ratio=0.15"]

BODY = r'''
import json
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.train import multidevice as tmd
from smilify_tpu_torch.train import trainer as ttrainer
from smilify_tpu_torch.train.config import load_config
from smilify_tpu_torch.train.multihost import all_gather_stack
from smilify_tpu_torch.train.multiview_setup import make_multiview_apply_fn, make_multiview_loss_fn
from smilify_tpu_torch.models.weight_port import build_model

work = sys.argv[1]
out = {}
sd = torch.load(os.path.join(work, "jax_init.pt"))
spec = toy_model_spec(device="cpu")
out["check"] = tmd.run_trainer_check(2, accum_steps=2, state_dict=sd, spec=spec, device="cpu")
out["local_bn"] = tmd.run_trainer_check(2, accum_steps=2, state_dict=sd, spec=spec, device="cpu",
                                        global_batchnorm=False, check=False)

def flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

def same_on_every_rank(model):
    every = all_gather_stack(flat(model))
    return float((every - every[0]).abs().max())

# the collective skip: rank 1's second batch fails on its way to the device
cfg = load_config(None, overrides={
    "model.backbone_name": "unet_micro", "training.batch_size": 4, "training.num_epochs": 1,
    "training.num_workers": 0, "training.device_data_cache": False,
    "augmentation.enabled": False, "output.save_checkpoint_every": 1}, mode="multi_view")
rcfg = tmd.tiny_multiview_config(spec, 2)
torch.manual_seed(0)
model = build_model(rcfg, img_size=32)
model.load_state_dict(sd)
rows = tmd.synthetic_multiview_batch(spec, 8, 2, 32, seed=3)
samples = [{k: v[i] for k, v in rows.items()} for i in range(8)]
calls = {"n": 0}
to_device = ttrainer.StagingCollator.to_device
def failing_to_device(self, batch, device):
    calls["n"] += 1
    if RANK == 1 and calls["n"] == 2:
        raise RuntimeError("injected: the batch did not reach its device")
    return to_device(self, batch, device)
ttrainer.StagingCollator.to_device = failing_to_device
mesh = ttrainer.data_mesh("cpu")
state = ttrainer.train_epochs(
    model, cfg, make_multiview_apply_fn(rcfg, spec, (32, 32)),
    lambda w: make_multiview_loss_fn(spec, rcfg, tmd.LOSS_WEIGHTS, (32, 32)),
    samples, [], 4, torch.device("cpu"), os.path.join(work, "skip_run"),
    ttrainer.TrainState(model.state_dict()), mesh=mesh)
ttrainer.StagingCollator.to_device = to_device
out["skip"] = {"steps": int(state.step), "spread": same_on_every_rank(model),
               "losses": len(state.history)}

# a NaN in rank 1's rows only: the reduced gradient is non-finite everywhere
torch.manual_seed(0)
model = build_model(rcfg, img_size=32)
model.load_state_dict(sd)
opt = ttrainer.build_optimizer(tmd._optimizer_config(), 1e-4, False, model)
step = ttrainer.make_train_step(model, make_multiview_apply_fn(rcfg, spec, (32, 32)),
                                make_multiview_loss_fn(spec, rcfg, tmd.LOSS_WEIGHTS, (32, 32)),
                                opt, 1, mesh)
batch = ttrainer.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in rows.items()})
if RANK == 1:
    batch["images"][0, 0, 0, 0, 0] = float("nan")
before = flat(model).clone()
step(batch)
out["nan"] = {"skipped": int(opt.total_notfinite), "moved": float((flat(model) - before).abs().max()),
              "spread": same_on_every_rank(model)}

# the trainer CLI over the two ranks
from smilify_tpu_torch.cli import train_regressor
state = train_regressor.main(json.loads(open(os.path.join(work, "cli_args.json")).read())
                             + ["--multihost", "--device", "cpu",
                                "--output-dir", os.path.join(work, "cli_ranks")])
out["cli_history"] = state.history

with open(os.path.join(work, f"out_{RANK}.json"), "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The JAX harness's single-device result, the single-process CLI run,
    and the two ranks' results."""
    from smilify_tpu_torch.cli import train_regressor

    root = tmp_path_factory.mktemp("multidevice")
    jspec = jmd.toy_model_spec()
    variables = jmd._build_setup(jspec, 2, RES, 2)[0]
    tspec = toy_model_spec(device="cpu")
    model = build_model(tmd.tiny_multiview_config(tspec, 2), img_size=RES)
    torch.save(state_dict_from_flax(variables, model), root / "jax_init.pt")
    jax_result = jmd.run_trainer_check(1, batch_size=4, accum_steps=2, compare_single=False,
                                       verbose=False, spec=jspec)

    folder, _ = write_replicant_sequence(str(root / "seq"), tspec, 12, RES, layout="unreal")
    cli_args = ["--model", write_model_pkl(str(root / "toy.pkl"), tspec), "--data-path", folder,
                "--epochs", "2", "--set", *TINY]
    (root / "cli_args.json").write_text(json.dumps(cli_args))
    plain = train_regressor.main(cli_args + ["--device", "cpu", "--output-dir", str(root / "cli_one")])

    run_ranks(2, BODY, root, args=[root], timeout=900)
    outs = [json.loads((root / f"out_{r}.json").read_text()) for r in range(2)]
    return root, jax_result, plain, outs


def test_data_parallel_step_matches_one_process_and_jax(launched):
    _, jax_result, _, outs = launched
    for out in outs:
        r = out["check"]
        assert r["n_ranks"] == 2
        assert all(v <= gate for v, gate in zip(
            (r["rel_gaps"][k] for k in ("loss", "eval_loss", "update_norm", "stats")),
            (tmd.LOSS_RTOL, tmd.LOSS_RTOL, tmd.UPDATE_RTOL, tmd.STATS_RTOL))), r["rel_gaps"]
        assert abs(r["loss"] - jax_result["loss"]) <= LOSS_RTOL * abs(jax_result["loss"]), (
            r["loss"], jax_result["loss"])
        assert abs(r["eval_loss"] - jax_result["eval_loss"]) <= LOSS_RTOL * abs(jax_result["eval_loss"])


def test_rank_local_batchnorm_fails_the_check(launched):
    _, _, _, outs = launched
    gaps = outs[0]["local_bn"]["rel_gaps"]
    assert gaps["stats"] > 100 * tmd.STATS_RTOL, gaps
    assert gaps["update_norm"] > tmd.UPDATE_RTOL, gaps


def test_failing_batch_on_one_rank_is_skipped_by_all(launched):
    _, _, _, outs = launched
    # 8 samples, a global batch of 4: 2 steps an epoch, rank 1's second lost
    assert [o["skip"]["steps"] for o in outs] == [1, 1]
    assert outs[0]["skip"]["spread"] == 0.0


def test_non_finite_gradient_on_one_rank_skips_every_update(launched):
    _, _, _, outs = launched
    for out in outs:
        assert out["nan"] == {"skipped": 1, "moved": 0.0, "spread": 0.0}, out["nan"]


def test_train_regressor_multihost_matches_one_process(launched):
    root, _, plain, outs = launched
    assert len(plain.history) == len(outs[0]["cli_history"]) == 2
    for want, got in zip(plain.history, outs[0]["cli_history"]):
        for k in ("loss", "val_loss"):
            assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), (k, got[k], want[k])
    one, _ = ttrainer.load_checkpoint(str(root / "cli_one" / "final_model"))
    ranks, _ = ttrainer.load_checkpoint(str(root / "cli_ranks" / "final_model"))
    a = torch.cat([v.double().reshape(-1) for k, v in sorted(one["model"].items())
                   if v.is_floating_point()])
    b = torch.cat([v.double().reshape(-1) for k, v in sorted(ranks["model"].items())
                   if v.is_floating_point()])
    assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a)) <= 1e-4
