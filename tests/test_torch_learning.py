"""The port's learning-proof tool (``smilify_tpu_torch/tools/prove_learning.py``)
at a toy size on the CPU (``unet_micro`` at 32², two or four epochs): the
plumbing, not the gates, which need the full runs on the card
(``chip_smoke.py`` phase 15 runs ``memorize``; ``heldout`` runs through the
tool, its reports committed). Held: the samples it scores are the JAX
package's seeded split for the same n and ratios (its test rows for
``heldout``), and an error planted in a training row's keypoints leaves the
held-out scores unchanged while one planted in a test row moves them; a run
in two calls (``until``) keeps an unbroken run's schedule, its first call's
epochs bit for bit, and counts every call's steps, and a call refuses an
``until`` off the schedule, another store or other settings; the heldout
configuration's train step against the JAX package's; the committed
reports of the card's runs against the JAX package's gate."""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import copy
import json
import os

import numpy as np
import pytest

from smilify_tpu.train.trainer import split_dataset as jax_split_dataset

from smilify_tpu_torch.cli import benchmark_model
from smilify_tpu_torch.tools import prove_learning

TOY = dict(epochs=2, backbone="unet_micro", res=32, device="cpu")


@pytest.fixture(scope="module")
def heldout_sv(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("heldout"))
    return work, prove_learning.run("sv", "heldout", work, samples=40, **TOY)


def test_heldout_scores_the_jax_split_test_rows(heldout_sv):
    _, r = heldout_sv
    want = jax_split_dataset(40, (0.85, 0.05, 0.10), 1234)[2]
    assert r["scored_split"] == "test" and r["scored_samples"] == sorted(int(i) for i in want)
    assert len(r["scored_samples"]) == 4 and 0 < r["scored_keypoints"] <= 4 * 55
    assert r["steps"] == 2 * (34 // 32) and np.isfinite(r["loss_ratio"])
    assert set(r["gates"]) == {"pck@10px"} and r["ok"] == (r["pck@10px"] >= 0.9)
    assert os.path.exists(os.path.join(heldout_sv[0], "learning_sv_heldout.json"))


def _errors(work, store):
    acc = benchmark_model.main([
        "--checkpoint", os.path.join(work, "heldout_sv", "final_model"), "--device", "cpu",
        "--output-dir", os.path.join(work, "bench"), "--split", "test",
        "--split-ratios", "0.85,0.05,0.1", "--split-seed", "1234"], source=store)
    return np.concatenate([np.ravel(e) for e in acc.pixel_errors_input])


def test_planted_error_in_a_training_row_leaves_heldout_scores(heldout_sv):
    from smilify_tpu_torch.core.spec import load_model_spec

    work, r = heldout_sv
    spec = load_model_spec(os.path.join(work, "stick_width.pkl"), align_symmetry=False, device="cpu")
    store = prove_learning.make_store(spec, 40, 1, 32, 11, "cpu")
    base = _errors(work, store)
    train_row = next(i for i in range(40) if i not in r["scored_samples"])
    for row, moves in ((train_row, False), (r["scored_samples"][0], True)):
        planted = copy.deepcopy(store)
        planted.arrays["multiview_keypoints/keypoints_2d"][row] += 7.0     # pixels
        got = _errors(work, planted)
        assert got.shape == base.shape
        assert (not np.array_equal(got, base)) == moves, (row, moves)


def test_memorize_multiview_plumbing(tmp_path):
    r = prove_learning.run("mv", "memorize", str(tmp_path), **TOY)
    train = jax_split_dataset(12, (0.99, 0.0, 0.01), 1234)[0]
    assert r["scored_split"] == "train" and r["scored_samples"] == sorted(int(i) for i in train)
    assert r["views"] == 2 and r["steps"] == 2 * (11 // 4)
    assert set(r["gates"]) == {"loss_ratio", "pck@5px", "pck@10px"}
    assert r["mpjpe"]["n"] > 0 and np.isfinite(r["loss_ratio"])


# ---------------------------------------------------------------------------
# a run in resumed calls (--until)
# ---------------------------------------------------------------------------

CHUNKED = dict(samples=40, epochs=4, backbone="unet_micro", res=32, device="cpu")


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """An unbroken 4-epoch run (its schedule changes at epochs 1, 2 and 3)
    and the same run in two calls, ``until=2`` then the rest."""
    whole_dir, cut_dir = (str(tmp_path_factory.mktemp(n)) for n in ("whole", "cut"))
    whole = prove_learning.run("sv", "heldout", whole_dir, **CHUNKED)
    first = prove_learning.run("sv", "heldout", cut_dir, until=2, **CHUNKED)
    rest = prove_learning.run("sv", "heldout", cut_dir, **CHUNKED)
    return dict(whole_dir=whole_dir, whole=whole, cut_dir=cut_dir, first=first, rest=rest)


def test_chunk_ends_are_the_schedule_changes():
    assert prove_learning.chunk_ends("heldout", 100) == [25, 50, 60, 77, 93, 100]
    assert prove_learning.chunk_ends("heldout", 4) == [1, 2, 3, 4]
    assert prove_learning.chunk_ends("memorize", 600) == [150, 300, 450, 600]


def _meta_config(path):
    from smilify_tpu_torch.train.config import config_from_dict

    with open(path + ".meta.json") as f:
        return config_from_dict(json.load(f)["config"])


def test_chunked_run_keeps_the_unbroken_schedule(chunked):
    c = chunked
    assert c["first"]["partial"] and c["first"]["until"] == 2 and "pck@10px" not in c["first"]
    hist, whole = c["rest"]["history"], c["whole"]["history"]
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in whole] == [0, 1, 2, 3]
    assert [h["lr"] for h in hist] == [h["lr"] for h in whole]
    # what each call's trainer ran with: the first call's config in its
    # epoch_1 checkpoint, the second's in final_model
    calls = [_meta_config(os.path.join(c["cut_dir"], "heldout_sv", n)) for n in ("epoch_1", "final_model")]
    want = _meta_config(os.path.join(c["whole_dir"], "heldout_sv", "final_model"))
    assert [cfg.training.num_epochs for cfg in calls] == [2, 4]
    for epoch in range(4):
        cfg = calls[epoch // 2]
        assert cfg.get_learning_rate_for_epoch(epoch) == want.get_learning_rate_for_epoch(epoch)
        assert cfg.get_loss_weights_for_epoch(epoch) == want.get_loss_weights_for_epoch(epoch), epoch
    weights = [want.get_loss_weights_for_epoch(e)["keypoint_2d"] for e in range(4)]
    assert weights == [0.05, 0.3, 1.0, 1.0]     # the curriculum does change inside the run


def test_chunked_run_first_epochs_are_the_unbroken_runs(chunked):
    hist, whole = chunked["rest"]["history"], chunked["whole"]["history"]
    for epoch in (0, 1):
        # bitwise: every loss and component (the first call's last epoch also
        # carries the visualization's metrics, which every call's end adds)
        assert {k: hist[epoch][k] for k in whole[epoch]} == whole[epoch], epoch
    assert hist[2]["loss"] != whole[2]["loss"]        # the resumed call's shuffle restarts


def test_chunked_run_counts_every_epochs_steps(chunked):
    rest = chunked["rest"]
    assert rest["steps_per_epoch"] == 34 // 32 and rest["steps"] == 4 * rest["steps_per_epoch"]
    assert [(ch["from"], ch["until"], ch["steps"]) for ch in rest["chunks"]] == [(0, 2, 2), (2, 4, 2)]
    assert rest["steps"] == chunked["whole"]["steps"]
    assert rest["store_sha256"] == chunked["first"]["store_sha256"] == chunked["whole"]["store_sha256"]
    assert set(rest["pck_curve"]) == {"1px", "2px", "5px", "10px", "20px", "50px"}
    assert rest["pck_curve"]["10px"] == rest["pck@10px"] and rest["loss_last"] == rest["history"][-1]["loss"]


@pytest.mark.parametrize("until", [30, 101])
def test_until_off_the_schedule_is_refused(tmp_path, until):
    with pytest.raises(ValueError, match="keep the optimizer trajectory"):
        prove_learning.run("sv", "heldout", str(tmp_path), until=until, **{**CHUNKED, "epochs": 100})
    with pytest.raises(SystemExit, match="is not one of"):
        prove_learning.main(["--mode", "sv", "--run", "heldout", "--until", str(until),
                             "--epochs", "100", "--samples", "40", "--backbone", "unet_micro",
                             "--res", "32", "--device", "cpu", "--workdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "heldout_sv")     # refused before anything is written


def test_resume_onto_another_store_is_refused(tmp_path):
    from smilify_tpu_torch.core.spec import load_model_spec

    prove_learning.run("sv", "heldout", str(tmp_path), until=1, **CHUNKED)
    spec = load_model_spec(str(tmp_path / "stick_width.pkl"), align_symmetry=False, device="cpu")
    other = prove_learning.make_store(spec, 40, 1, 32, 12, "cpu")       # seed 12, not 11
    with pytest.raises(ValueError, match="SHA-256"):
        prove_learning.run("sv", "heldout", str(tmp_path), until=2, store=other, **CHUNKED)
    with pytest.raises(ValueError, match="started with"):
        prove_learning.run("sv", "heldout", str(tmp_path), until=2, **{**CHUNKED, "samples": 41})
    with open(tmp_path / "heldout_sv" / prove_learning.RECORD) as f:
        assert [(c["from"], c["until"]) for c in json.load(f)["chunks"]] == [(0, 1)]


def test_carry_keeps_what_the_next_call_reads(chunked, tmp_path):
    """A run directory carried to another machine: the record and the
    resume checkpoint without the optimizer's moments; the call resumed
    from the carried directory trains as the one resumed in place."""
    import shutil

    import torch

    src = os.path.join(chunked["cut_dir"], "heldout_sv")
    dest = tmp_path / "carried"
    prove_learning.carry_run(src, 2, str(dest / "heldout_sv"))
    assert sorted(os.listdir(dest / "heldout_sv")) == sorted(
        ["chunks.json", "epoch_1.pt", "epoch_1.meta.json"])
    payload = torch.load(dest / "heldout_sv" / "epoch_1.pt", weights_only=False)
    assert payload["opt_state"] is None
    full = torch.load(os.path.join(src, "epoch_1.pt"), weights_only=False)["model"]
    assert all(torch.equal(full[k], v) for k, v in payload["model"].items())
    with open(dest / "heldout_sv" / "chunks.json") as f:
        record = json.load(f)
    # the record as the first call left it: one chunk, two epochs
    record["chunks"], record["history"] = record["chunks"][:1], record["history"][:2]
    with open(dest / "heldout_sv" / "chunks.json", "w") as f:
        json.dump(record, f)
    shutil.copy(os.path.join(chunked["whole_dir"], "stick_width.pkl"), dest)
    r = prove_learning.run("sv", "heldout", str(dest), **CHUNKED)
    assert r["history"] == chunked["rest"]["history"]


# ---------------------------------------------------------------------------
# the heldout configuration's train step held to the JAX package
# ---------------------------------------------------------------------------

STEP_EPOCH, STEP_RES, STEP_BATCH, STEP_SEED = 60, 96, 2, 4


def test_heldout_train_step_matches_jax(tmp_path):
    """One train step of the heldout proof's single-view regressor
    (``unet_mid``, IEF depth 3, 4 heads, 3 iterations, dropout 0) at B=2
    and 96², with the run's loss weights and lr at epoch 60 (keypoint_2d
    1.0, lr 3e-4) on a batch of the proof's own samples (seed 11), the JAX
    model's seeded variables carried across: the loss within 1e-5
    relative, the raw gradients, the updates and the BatchNorm statistics in
    relative L2 with ``test_torch_train.py``'s tolerances (its docstring
    says why not element by element). The variables are the seed-4 draw
    of ``random_variables``: the seed-12 draw puts the loss at ~6,456, where
    float32 itself is ~3e-3 from exact gradients (a float64 evaluation of
    the port: the port 2.97e-3 from it, JAX 5.81e-3, the two 2.98e-3
    apart), more than the tolerance any float32 pair could keep."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from smilify_tpu.models import regressor as jreg
    from smilify_tpu.models.regressor import SMILRegressor
    from smilify_tpu.train import config as jconfig
    from smilify_tpu.train import trainer as jtrainer
    from smilify_tpu.train.multidevice import toy_model_spec as j_toy_spec

    from smilify_tpu_torch.cli.train_regressor import (
        make_singleview_apply_fn,
        make_target_fn,
        parse_set_overrides,
    )
    from smilify_tpu_torch.core.spec import toy_model_spec as t_toy_spec
    from smilify_tpu_torch.data.hdf5_dataset import MultiViewHDF5Dataset, collate_multiview
    from smilify_tpu_torch.models import regressor as treg
    from smilify_tpu_torch.models.weight_port import state_dict_from_flax
    from smilify_tpu_torch.train import config as tconfig
    from smilify_tpu_torch.train import trainer as ttrainer
    from tests.test_torch_models import random_variables
    from tests.test_torch_train import GRAD_RTOL, LOSS_RTOL, MARGIN, MIN_KEPT, STATS_RTOL, UPDATE_RTOL

    over = parse_set_overrides(prove_learning.overrides("sv", "heldout", 100, "unet_mid", STEP_RES))
    tcfg = tconfig.load_config(None, overrides=over, mode="single_view")
    jcfg = jconfig.load_config(None, overrides=over, mode="single_view")
    weights, lr = tcfg.get_loss_weights_for_epoch(STEP_EPOCH), tcfg.get_learning_rate_for_epoch(STEP_EPOCH)
    assert weights == jcfg.get_loss_weights_for_epoch(STEP_EPOCH) and weights["keypoint_2d"] == 1.0
    assert lr == jcfg.get_learning_rate_for_epoch(STEP_EPOCH) == 3e-4
    assert (tcfg.model.transformer_depth, tcfg.model.transformer_heads, tcfg.model.transformer_ief_iters,
            tcfg.model.backbone_name, tcfg.model.transformer_dropout) == (3, 4, 3, "unet_mid", 0.0)

    tspec, jspec = t_toy_spec(*prove_learning.STICK_WIDTH, device="cpu"), j_toy_spec(*prove_learning.STICK_WIDTH)
    store = prove_learning.make_store(tspec, STEP_BATCH, 1, STEP_RES, 11, "cpu")
    ds = MultiViewHDF5Dataset(store, return_single_view=True, expand_all_views=True)
    batch = {k: torch.as_tensor(v) for k, v in collate_multiview([ds[i] for i in range(STEP_BATCH)]).items()}
    batch = ttrainer.narrow_floats(batch)
    targets = make_target_fn(tspec, [])(batch)
    jtargets = {k: jnp.asarray(v.numpy()) for k, v in targets.items()}
    image = jnp.asarray(batch["image"].numpy())

    jrcfg, trcfg = jcfg.regressor_config(jspec), tcfg.regressor_config(tspec)
    jmodel = SMILRegressor(jrcfg)
    v = random_variables(jmodel, jnp.zeros((1, STEP_RES, STEP_RES, 3)), seed=STEP_SEED)

    def compute(params, stats):
        (raw, hist), mutated = jmodel.apply({"params": params, "batch_stats": stats}, image, train=True,
                                            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        preds = jreg.decode_predictions(jrcfg, raw, jspec)
        preds["ief_history"] = hist
        loss = jreg.compute_batch_loss(jspec, jrcfg, preds, jtargets, weights,
                                       image_size=(STEP_RES, STEP_RES))[0]
        return loss, mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(compute, has_aux=True))(v["params"], v["batch_stats"])
    tx = jtrainer.build_optimizer(jcfg, lr, False)
    updates, _ = tx.update(jgrads, tx.init(v["params"]), v["params"])
    jparams = optax.apply_updates(v["params"], updates)

    model = treg.SMILRegressor(trcfg, img_size=STEP_RES)
    model.load_state_dict(state_dict_from_flax(v, model))
    start = {k: t.clone() for k, t in model.state_dict().items()}
    opt = ttrainer.build_optimizer(tcfg, lr, False, model)
    raw_grads, inner_step = {}, opt.step

    def step_and_keep_grads():
        raw_grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        inner_step()

    opt.step = step_and_keep_grads
    apply_fn, target_dict = make_singleview_apply_fn(trcfg, tspec), make_target_fn(tspec, [])

    def t_loss(preds, b):
        return treg.compute_batch_loss(tspec, trcfg, preds, target_dict(b), weights,
                                       image_size=(STEP_RES, STEP_RES))

    tloss, _ = ttrainer.make_train_step(model, apply_fn, t_loss, opt)(batch)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (float(tloss), float(jloss))

    gwant = state_dict_from_flax({"params": jgrads, "batch_stats": jstats}, model)
    swant = state_dict_from_flax({"params": jparams, "batch_stats": jstats}, model)
    got = model.state_dict()
    names = list(raw_grads)
    g = {n: raw_grads[n].double().numpy() for n in names}
    w = {n: gwant[n].double().numpy() for n in names}
    decided = {n: np.abs(g[n] - w[n]) * MARGIN < np.abs(w[n]) for n in names}
    upd = {n: (got[n] - start[n]).double().numpy() for n in names}
    jupd = {n: (swant[n] - start[n]).double().numpy() for n in names}

    def rel_l2(a, b):
        return (sum(float(np.sum((a[n] - b[n]) ** 2)) for n in a) / sum(float(np.sum(b[n] ** 2)) for n in b)) ** 0.5

    stat_names = [n for n in got if n.endswith(("running_mean", "running_var"))]
    gaps = {"grad": rel_l2(g, w),
            "update": rel_l2({n: upd[n] * decided[n] for n in names}, {n: jupd[n] * decided[n] for n in names}),
            "kept": sum(int(d.sum()) for d in decided.values()) / sum(d.size for d in decided.values()),
            "stats": max(rel_l2({n: got[n].double().numpy()}, {n: swant[n].double().numpy()})
                         for n in stat_names)}
    assert gaps["grad"] <= GRAD_RTOL, gaps
    assert gaps["update"] <= UPDATE_RTOL and gaps["kept"] >= MIN_KEPT, gaps
    assert gaps["stats"] <= STATS_RTOL, gaps


# ---------------------------------------------------------------------------
# the committed reports of the card's heldout runs
# ---------------------------------------------------------------------------

REPORTS = os.path.join(os.path.dirname(prove_learning.__file__), "reports", "generalization")
GATE_RUNS = {"sv": dict(n_samples=25600, views=1, steps=68000),
             "mv": dict(n_samples=1600, views=4, steps=17000)}


@pytest.mark.parametrize("mode", sorted(GATE_RUNS))
def test_torch_generalization_reports_gate(mode):
    """The counterpart of ``tests/test_learning.py::test_generalization_artifacts_gate``
    over the port's committed reports (``tools/prove_learning.py --run
    heldout`` on the card, in resumed calls): the JAX package's committed
    sizes, the seeded split, a card's run with its store digest, every
    call's steps counted, and held-out PCK@10 ≥ 0.9."""
    with open(os.path.join(REPORTS, mode, f"learning_{mode}_heldout.json")) as f:
        r = json.load(f)
    want = GATE_RUNS[mode]
    assert (r["mode"], r["run"], r["n_samples"], r["views"], r["epochs"]) == (
        mode, "heldout", want["n_samples"], want["views"], 100)
    assert r["split_ratios"] == [0.85, 0.05, 0.10] and r["split_seed"] == 1234
    assert r["scored_split"] == "test" and len(r["scored_samples"]) == want["n_samples"] // 10
    assert r["device"].startswith("cuda") and r["card"] and all(c["card"] for c in r["chunks"])
    assert len(r["store_sha256"]) == 64
    assert r["steps"] == want["steps"] == sum(c["steps"] for c in r["chunks"])
    ends = [(c["from"], c["until"]) for c in r["chunks"]]
    assert ends[0][0] == 0 and ends[-1][1] == 100 and all(
        a[1] == b[0] for a, b in zip(ends, ends[1:])), ends
    assert {c["until"] for c in r["chunks"]} <= set(prove_learning.chunk_ends("heldout", 100))
    assert [h["epoch"] for h in r["history"]] == list(range(100))
    assert r["loss_last"] == r["history"][-1]["loss"] and r["val_loss_last"] is not None
    assert set(r["pck_curve"]) == {"1px", "2px", "5px", "10px", "20px", "50px"}
    if mode == "mv":
        assert r["mpjpe"]["mpjpe_mm"] > 0 and r["mpjpe"]["n"] > 0
    assert os.path.exists(os.path.join(REPORTS, mode, "benchmark_report.txt"))
    assert r["ok"] and r["pck@10px"] >= r["gates"]["pck@10px"] == 0.9
