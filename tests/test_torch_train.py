"""The port's training core held to the JAX package on the CPU.

* The BatchNorm repair: the port's ``FlaxBatchNorm2d`` against Flax's
  ``nn.BatchNorm`` after 1 and 3 train-mode calls — outputs within 1e-6
  absolute, running means within 1e-6 absolute and running variances within
  1e-6 relative (float32 means and variances of the same values summed in
  another order; Flax's fast variance E[x²] − E[x]² against torch's).
* ``build_optimizer``: the groups against the labels the JAX package's
  ``label_fn`` gives (read from optax's ``multi_transform`` state); the
  global-norm clip just above and just below ``max_norm`` with the frozen
  backbone's gradients in the norm; ``apply_if_finite(16)``: a NaN step, 16
  in a row and the 17th applied; a rebuilt optimizer (a new lr) starting
  from fresh moments; the frozen backbone keeping no state. Parameters
  within 1e-7 absolute after each update (one float32 Adam step of lr 1e-3:
  rounding of the moments' arithmetic in another order).
* ``make_train_step``: 3 steps of a small single-view regressor
  (``unet_small`` at 32², IEF decoder 1 deep, dropout off, AdamW at lr 1e-5
  with the clip, weights carried with ``state_dict_from_flax``) at
  ``accum_steps`` 1 and 2, after each step: the loss within 1e-5 relative;
  the raw gradients within 2e-3 in relative L2 over all parameters; the
  parameters' updates within 2e-3 in relative L2; every BatchNorm
  statistic within 1e-5 relative. Why not element by element: float32
  rounding of a BatchNorm's statistics flips a ReLU whose input is within
  ~1e-5 of zero (torch's CPU kernels flip a few such ReLUs against XLA's
  at some thread counts and not at others), which moves every gradient
  upstream of it by up to ~1% of its largest entry (measured: 7.9e-4 in
  relative L2 at 1 thread, 2.6e-6 at 2), and Adam's first step takes each
  element's sign, so an element whose gradient changes by a hundredth of
  its size or more (and the IEF self-attention's query and key over one
  token, whose gradient is zero in exact arithmetic) may move by ±lr
  either way. The update comparison covers the elements whose two
  gradients agree within 1% at every step so far (at least 10% of them;
  measured 24-100%). lr 1e-5 keeps the two trajectories within the loss
  tolerance over 3 steps. ``make_eval_step``'s loss and components within
  1e-5 relative, the statistics untouched.
* ``iterate_batches``: the JAX package's batches for the same seed in the
  serial, thread and process modes, and its ``skip_errors`` backfill.
* ``end_of_epoch_outputs``: the JAX package's checkpoint names and cadence;
  ``try_resume`` (with ``reset_ief_token_embedding``) and
  ``plot_training_history`` (the JAX one's four PNGs, written without
  matplotlib).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from smilify_tpu.models import regressor as jreg
from smilify_tpu.train import config as jconfig
from smilify_tpu.train import trainer as jtrainer
from smilify_tpu.train.multidevice import toy_model_spec as j_toy_spec

from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn, make_target_fn
from smilify_tpu_torch.core.spec import toy_model_spec as t_toy_spec
from smilify_tpu_torch.models import regressor as treg
from smilify_tpu_torch.models.backbones import FlaxBatchNorm2d
from smilify_tpu_torch.models.weight_port import flax_module_paths, state_dict_from_flax
from smilify_tpu_torch.train import config as tconfig
from smilify_tpu_torch.train import trainer as ttrainer
from tests._torch_datasets import IndexDataset
from tests._torch_no_plotlibs import block_plot_libraries
from tests.test_torch_models import assert_close, random_variables

BN_TOL = 1e-6
OPT_TOL = 1e-7
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL, STATS_RTOL = 1e-5, 2e-3, 2e-3, 1e-5
MIN_KEPT = 0.1
MARGIN = 100.0
LR = 1e-5
RES = 32


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("calls", [1, 3])
def test_batchnorm_running_statistics_match_flax(calls):
    from flax import linen as fnn

    rng = np.random.default_rng(calls)
    xs = [(rng.standard_normal((2, 3, 3, 4)) * 2 + 1).astype(np.float32) for _ in range(calls)]
    jbn = fnn.BatchNorm(use_running_average=False)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    tbn = FlaxBatchNorm2d(4, eps=1e-5, momentum=0.01).train()
    for x in xs:
        y, mut = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        yt = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert_close(yt, np.asarray(y), BN_TOL, "normalized output")
    assert_close(tbn.running_mean, np.asarray(v["batch_stats"]["mean"]), BN_TOL, "running mean")
    want = np.asarray(v["batch_stats"]["var"])
    rel = np.abs(tbn.running_var.numpy() / want - 1).max()
    assert rel <= BN_TOL, f"running var off by {rel:.3g} relative"
    # eval mode normalizes with the running statistics, as Flax's use_running_average
    jeval = fnn.BatchNorm(use_running_average=True).apply(v, jnp.asarray(xs[0]))
    assert_close(tbn.eval()(torch.from_numpy(xs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                 np.asarray(jeval), BN_TOL, "eval output")


# ---------------------------------------------------------------------------
# the optimizer on a two-layer model: a "backbone" and a "head"
# ---------------------------------------------------------------------------


class TwoLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(3, 4)
        self.head = nn.Linear(4, 2)


def _configs(**over):
    over = {"optimizer.optimizer_type": "adam", **over}
    return tconfig.load_config(None, overrides=over), jconfig.load_config(None, overrides=over)


def _two_layer(seed=0):
    """(port model, its Flax params tree) with the same seeded values."""
    torch.manual_seed(seed)
    model = TwoLayer()
    params = {name: {"kernel": m.weight.detach().numpy().T.copy(),
                     "bias": m.bias.detach().numpy().copy()}
              for name, m in (("backbone", model.backbone), ("head", model.head))}
    return model, params


def _grads(rng, scale=1.0, nan=False):
    g = {"backbone": {"kernel": rng.standard_normal((3, 4)), "bias": rng.standard_normal(4)},
         "head": {"kernel": rng.standard_normal((4, 2)), "bias": rng.standard_normal(2)}}
    g = jax.tree.map(lambda a: (a * scale).astype(np.float32), g)
    if nan:
        g["head"]["bias"][0] = np.nan
    return g


def _port_step(model, opt, g):
    for name, m in (("backbone", model.backbone), ("head", model.head)):
        m.weight.grad = torch.from_numpy(np.ascontiguousarray(g[name]["kernel"].T))
        m.bias.grad = torch.from_numpy(g[name]["bias"].copy())
    opt.step()


def _assert_params(model, params, what):
    for name, m in (("backbone", model.backbone), ("head", model.head)):
        assert_close(m.weight.T, np.asarray(params[name]["kernel"]), OPT_TOL, f"{what} {name}.weight")
        assert_close(m.bias, np.asarray(params[name]["bias"]), OPT_TOL, f"{what} {name}.bias")


def _jax_run(tx, params, grads_list, opt_state=None):
    opt_state = tx.init(params) if opt_state is None else opt_state
    for g in grads_list:
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_groups_follow_the_jax_labels(frozen):
    """The groups of a single-view regressor's parameters, through
    flax_module_paths, against the labels optax's multi_transform state
    holds (a parameter's Adam moments live in its label's masked state)."""
    from smilify_tpu.models.regressor import SMILRegressor

    over = {"model.backbone_name": "unet_micro", "model.transformer_depth": 1,
            "model.transformer_heads": 2, "model.transformer_dim_head": 8,
            "model.transformer_mlp_dim": 16}
    tcfg, jcfg = _configs(**over)
    v = random_variables(SMILRegressor(jcfg.regressor_config(j_toy_spec(8, 6, 3))),
                         jnp.zeros((1, RES, RES, 3)))
    tx = jtrainer.build_optimizer(jcfg, 1e-3, frozen)
    state = tx.init(v["params"])
    by_label = {}
    for label, masked in state.inner_state[1].inner_states.items():
        mu = masked.inner_state[0].mu if label != "backbone_frozen" else masked.inner_state
        leaves = jax.tree_util.tree_flatten_with_path(
            mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for path, leaf in leaves:
            if not isinstance(leaf, optax.MaskedNode):
                by_label["/".join(str(p.key) for p in path)] = label
    if frozen:     # set_to_zero keeps no state: the frozen group is what no other label holds
        all_paths = ["/".join(str(p.key) for p in path)
                     for path, _ in jax.tree_util.tree_flatten_with_path(v["params"])[0]]
        by_label.update({p: "backbone_frozen" for p in all_paths if p not in by_label})
    model = treg.SMILRegressor(tcfg.regressor_config(t_toy_spec(8, 6, 3, device="cpu")),
                               img_size=RES)
    model.load_state_dict(state_dict_from_flax(v, model))
    opt = ttrainer.build_optimizer(tcfg, 1e-3, frozen, model)
    paths = flax_module_paths(model)
    assert set(opt.labels.values()) == ({"head", "backbone_frozen"} if frozen else {"head", "backbone"})
    for name, label in opt.labels.items():
        jax_labels = {lab for p, lab in by_label.items()
                      if p == paths[name] or p.startswith(paths[name] + "/")}
        assert jax_labels == {label}, (name, paths[name], jax_labels, label)
    # a frozen backbone keeps no Adam state; the groups' learning rates
    groups = opt.inner.param_groups
    lrs = [1e-3] if frozen else [1e-3, 1e-3 * tcfg.model.backbone_lr_multiplier]
    assert [g["lr"] for g in groups] == lrs


@pytest.mark.parametrize("total", [0.999, 1.001])
def test_clip_counts_the_frozen_gradients(total):
    """‖g‖ just below and just above max_norm = 1, with the frozen
    backbone's gradient holding most of the norm: only a clip over every
    gradient scales the head's update as optax's does."""
    tcfg, jcfg = _configs(**{"optimizer.gradient_clip_norm": 1.0})
    rng = np.random.default_rng(7)
    g = _grads(rng)
    g["head"] = jax.tree.map(lambda a: a * 0.05, g["head"])
    norm = float(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a in jax.tree.leaves(g))))
    g = jax.tree.map(lambda a: (a * (total / norm)).astype(np.float32), g)
    model, params = _two_layer()
    opt = ttrainer.build_optimizer(tcfg, 1e-3, True, model)
    for _ in range(2):      # the second step's Adam update depends on the clip's scale
        _port_step(model, opt, g)
    g_half = jax.tree.map(lambda a: a * 0.5, g)
    _port_step(model, opt, g_half)
    want, _ = _jax_run(jtrainer.build_optimizer(jcfg, 1e-3, True), params, [g, g, g_half])
    _assert_params(model, want, f"‖g‖ = {total}")
    assert_close(opt.grad_norm, np.float32(total * 0.5), 1e-6, "the last step's global norm")
    assert all(p not in opt.inner.state for p in model.backbone.parameters())


def test_apply_if_finite_skips_then_gives_up_after_16():
    tcfg, jcfg = _configs()
    rng = np.random.default_rng(3)
    model, params = _two_layer(1)
    opt = ttrainer.build_optimizer(tcfg, 1e-3, False, model)
    tx = jtrainer.build_optimizer(jcfg, 1e-3, False)
    good = [_grads(rng) for _ in range(2)]
    for g in good:
        _port_step(model, opt, g)
    jparams, jstate = _jax_run(tx, params, good)
    step_before = float(opt.adam_step())
    # one NaN step: nothing moves, Adam's count included; the next good step resets the count
    _port_step(model, opt, _grads(rng, nan=True))
    jparams, jstate = _jax_run(tx, jparams, [_grads(np.random.default_rng(99), nan=True)], jstate)
    _assert_params(model, jparams, "after a NaN step")
    assert float(opt.adam_step()) == step_before == 2.0
    assert int(opt.notfinite_count) == int(jstate.notfinite_count) == 1
    g = _grads(rng)
    _port_step(model, opt, g)
    jparams, jstate = _jax_run(tx, jparams, [g], jstate)
    _assert_params(model, jparams, "after the next good step")
    assert int(opt.notfinite_count) == int(jstate.notfinite_count) == 0
    assert float(opt.adam_step()) == 3.0
    # 16 NaN steps in a row are skipped; the 17th is applied (and poisons the parameters)
    for k in range(1, 18):
        _port_step(model, opt, _grads(rng, nan=True))
        jparams, jstate = _jax_run(tx, jparams, [_grads(np.random.default_rng(k), nan=True)], jstate)
        assert int(opt.notfinite_count) == int(jstate.notfinite_count) == k
        applied = not bool(torch.isfinite(model.head.bias).all())
        assert applied == (not np.isfinite(np.asarray(jparams["head"]["bias"])).all()) == (k == 17)
    assert int(opt.total_notfinite) == int(jstate.total_notfinite) == 18


def test_a_new_learning_rate_starts_from_fresh_moments():
    """The trainers rebuild the optimizer when (weights, lr, frozen)
    changes, and optax's tx.init starts Adam anew: a rebuilt optimizer's
    first step is a bias-corrected first step (±lr)."""
    tcfg, jcfg = _configs(**{"optimizer.optimizer_type": "adamw"})
    rng = np.random.default_rng(5)
    model, params = _two_layer(2)
    gs = [_grads(rng, 0.1) for _ in range(3)]
    opt = ttrainer.build_optimizer(tcfg, 1e-3, False, model)
    for g in gs[:2]:
        _port_step(model, opt, g)
    opt = ttrainer.build_optimizer(tcfg, 3e-4, False, model)
    _port_step(model, opt, gs[2])
    assert float(opt.adam_step()) == 1.0
    jparams, _ = _jax_run(jtrainer.build_optimizer(jcfg, 1e-3, False), params, gs[:2])
    jparams, _ = _jax_run(jtrainer.build_optimizer(jcfg, 3e-4, False), jparams, gs[2:])
    _assert_params(model, jparams, "after the rebuild")


# ---------------------------------------------------------------------------
# train and eval steps of a small single-view regressor
# ---------------------------------------------------------------------------

SMALL = {"model.backbone_name": "unet_small", "model.input_resolution": RES,
         "model.transformer_depth": 1, "model.transformer_heads": 2,
         "model.transformer_dim_head": 8, "model.transformer_mlp_dim": 16,
         "model.transformer_dropout": 0.0, "training.use_mixed_precision": False,
         "model.freeze_backbone": False}
WEIGHTS = {"keypoint_3d": 0.5}
TARGET_KEYS = ("global_rot", "joint_rot", "betas", "trans", "keypoints_3d")


def _batches(n, batch=4, J=6, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [{"image": rng.random((batch, RES, RES, 3), dtype=np.float32),
             "global_rot": 0.3 * f(batch, 3), "joint_rot": 0.2 * f(batch, J - 1, 3),
             "betas": 0.5 * f(batch, 3), "trans": 0.1 * f(batch, 3),
             "keypoints_3d": f(batch, J, 3), "keypoints_2d": rng.random((batch, J, 2), dtype=np.float32),
             "keypoint_visibility": (rng.random((batch, J)) > 0.2).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def small():
    """The JAX model's variables, apply/loss functions and a jitted raw
    gradient, and a builder of the port's model carrying those variables."""
    from smilify_tpu.models.regressor import SMILRegressor

    tcfg, jcfg = _configs(**{**SMALL, "optimizer.optimizer_type": "adamw"})
    jspec, tspec = j_toy_spec(8, 6, 3), t_toy_spec(8, 6, 3, device="cpu")
    jrcfg, trcfg = jcfg.regressor_config(jspec), tcfg.regressor_config(tspec)
    jmodel = SMILRegressor(jrcfg)
    v = random_variables(jmodel, jnp.zeros((1, RES, RES, 3)), seed=4)

    def apply_fn(variables, batch, train):
        (raw, hist), mutated = jmodel.apply(variables, batch["image"], train=train,
                                            mutable=["batch_stats"] if train else [],
                                            rngs={"dropout": jax.random.PRNGKey(0)} if train else None)
        preds = jreg.decode_predictions(jrcfg, raw, jspec)
        preds["ief_history"] = hist
        return preds, (mutated.get("batch_stats", variables["batch_stats"]) if train else None)

    def loss_fn(preds, batch):
        targets = {k: batch[k] for k in TARGET_KEYS}
        targets.update(keypoints_2d=batch["keypoints_2d"], kp_visibility=batch["keypoint_visibility"])
        return jreg.compute_batch_loss(jspec, jrcfg, preds, targets, WEIGHTS, image_size=(RES, RES))

    def compute(params, stats, batch):
        preds, new_stats = apply_fn({"params": params, "batch_stats": stats}, batch, True)
        return loss_fn(preds, batch)[0], new_stats

    grad_fn = jax.jit(jax.value_and_grad(compute, has_aux=True))
    target_dict = make_target_fn(tspec, [])

    def t_loss(preds, batch):
        return treg.compute_batch_loss(tspec, trcfg, preds, target_dict(batch), WEIGHTS,
                                       image_size=(RES, RES))

    def port_model():
        model = treg.SMILRegressor(trcfg, img_size=RES)
        model.load_state_dict(state_dict_from_flax(v, model))
        return model

    return dict(tcfg=tcfg, jcfg=jcfg, v=v, apply_fn=apply_fn, loss_fn=loss_fn, grad_fn=grad_fn,
                t_apply=make_singleview_apply_fn(trcfg, tspec), t_loss=t_loss, port_model=port_model)


def _rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖ over every tensor of the two lists together."""
    d = sum(float(np.sum((g.detach().double().numpy() - w) ** 2)) for g, w in zip(got, want))
    return (d / sum(float(np.sum(w ** 2)) for w in want)) ** 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(small, accum):
    s = small
    batches = _batches(3, batch=2 * accum)       # micro-batches of 2: one gradient shape to compile
    tx = jtrainer.build_optimizer(s["jcfg"], LR, False)
    jstep = jtrainer.make_train_step(s["apply_fn"], s["loss_fn"], tx, accum)
    params, stats = s["v"]["params"], s["v"]["batch_stats"]
    opt_state = tx.init(params)
    model = s["port_model"]()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ttrainer.build_optimizer(s["tcfg"], LR, False, model)
    raw_grads = {}
    inner_step = opt.step

    def step_and_keep_grads():
        raw_grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        inner_step()

    opt.step = step_and_keep_grads
    tstep = ttrainer.make_train_step(model, s["t_apply"], s["t_loss"], opt, accum)
    decided = {}
    for k, batch in enumerate(batches):
        # the JAX step's raw gradients, micro-batch by micro-batch as its scan takes them
        grads, st = None, stats
        for mb in [{n: a.reshape((accum, -1) + a.shape[1:])[i] for n, a in batch.items()}
                   for i in range(accum)]:
            (_, st), g = s["grad_fn"](params, st, mb)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / accum, grads)
        params, stats, opt_state, jloss, _ = jstep(params, stats, opt_state, batch)
        tloss, _ = tstep({n: torch.from_numpy(a) for n, a in batch.items()})
        what = f"accum {accum}, step {k + 1}"
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), what
        gwant = state_dict_from_flax({"params": grads, "batch_stats": stats}, model)
        swant = state_dict_from_flax({"params": params, "batch_stats": stats}, model)
        got = model.state_dict()
        names = list(raw_grads)
        for n in names:
            # an element's Adam update takes its gradient's sign: where the two
            # gradients differ by more than 1/MARGIN of its size (a ReLU that
            # rounding flips, a gradient that is zero in exact arithmetic) the
            # updates may differ by 2·lr, and that element leaves the comparison
            g, w = raw_grads[n].double().numpy(), gwant[n].double().numpy()
            decided[n] = decided.get(n, True) & (np.abs(g - w) * MARGIN < np.abs(w))
        stat_names = [n for n in got if n.endswith(("running_mean", "running_var"))]
        upd = [(got[n] - start[n]).double().numpy() for n in names]
        jupd = [(swant[n] - start[n]).double().numpy() for n in names]
        kept = sum(int(decided[n].sum()) for n in names) / sum(decided[n].size for n in names)
        gaps = {"grad": _rel_l2([raw_grads[n] for n in names],
                                [gwant[n].double().numpy() for n in names]),
                "update": _rel_l2([torch.from_numpy(u * decided[n]) for u, n in zip(upd, names)],
                                  [u * decided[n] for u, n in zip(jupd, names)]),
                "kept": kept,
                "stats": max(_rel_l2([got[n]], [swant[n].double().numpy()]) for n in stat_names)}
        assert gaps["grad"] <= GRAD_RTOL, (what, gaps)
        assert gaps["update"] <= UPDATE_RTOL and gaps["kept"] >= MIN_KEPT, (what, gaps)
        assert gaps["stats"] <= STATS_RTOL, (what, gaps)


def test_eval_step_matches_jax(small):
    s = small
    batch = _batches(1, seed=2)[0]
    jloss, jobjs = jtrainer.make_eval_step(s["apply_fn"], s["loss_fn"])(
        s["v"]["params"], s["v"]["batch_stats"], batch)
    model = s["port_model"]()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tloss, tobjs = ttrainer.make_eval_step(model, s["t_apply"], s["t_loss"])(
        {n: torch.from_numpy(a) for n, a in batch.items()})
    assert sorted(tobjs) == sorted(jobjs)
    for k in jobjs:
        assert abs(float(tobjs[k]) - float(jobjs[k])) <= LOSS_RTOL * max(abs(float(jobjs[k])), 1e-12), k
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())   # eval mode


# ---------------------------------------------------------------------------
# the epoch runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,workers", [("serial", 0), ("thread", 3), ("process", 2)])
def test_iterate_batches_matches_jax(mode, workers):
    kw = dict(num_workers=workers, worker_mode="thread" if mode == "serial" else mode)
    ds = IndexDataset(13)            # one dataset: the process pools are cached by dataset
    for shuffle, fraction, drop_last in ((True, 1.0, True), (True, 0.7, False), (False, 1.0, False)):
        got = list(ttrainer.iterate_batches(ds, 4, np.random.default_rng(5), shuffle=shuffle,
                                            fraction=fraction, drop_last=drop_last, **kw))
        want = list(jtrainer.iterate_batches(ds, 4, np.random.default_rng(5), shuffle=shuffle,
                                             fraction=fraction, drop_last=drop_last))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["x"], b["x"])
    # skip_errors: the failing samples are dropped and their slots filled from the epoch's rest
    bad = IndexDataset(14, bad=(3, 7))
    got = list(ttrainer.iterate_batches(bad, 4, np.random.default_rng(1), skip_errors=True, **kw))
    want = list(jtrainer.iterate_batches(bad, 4, np.random.default_rng(1), skip_errors=True))
    seen = np.concatenate([b["x"][:, 0] for b in got])
    assert len(got) == 3 and 3.0 not in seen and 7.0 not in seen
    np.testing.assert_array_equal(seen, np.concatenate([b["x"][:, 0] for b in want]))
    with pytest.raises(ValueError, match="corrupt"):
        list(ttrainer.iterate_batches(bad, 2, np.random.default_rng(0), **kw))


def test_end_of_epoch_outputs_match_jax(tmp_path):
    """The same files on the same cadence: best_model when the validation
    loss improves, epoch_N + final_model every save_checkpoint_every epochs
    and at the last (the port's ``.pt``, the JAX package's orbax folders)."""
    over = {"output.save_checkpoint_every": 2, "output.plot_history_every": 100}
    tcfg, jcfg = _configs(**over)
    tstate = ttrainer.TrainState({"w": torch.zeros(2)}, opt_state={"m": torch.ones(1)})
    jstate = jtrainer.TrainState(params={"w": np.zeros(2, np.float32)}, batch_stats={},
                                 opt_state={"m": np.ones(1, np.float32)})
    tbest = jbest = float("inf")
    for epoch, val in enumerate([3.0, 2.0, 2.5, 1.0, 1.5]):
        for state in (tstate, jstate):
            state.epoch = epoch
            state.history.append({"epoch": epoch, "loss": 1.0, "val_loss": val})
        last = epoch == 4
        tbest = ttrainer.end_of_epoch_outputs(str(tmp_path / "t"), tstate, tcfg, epoch, last, tbest)
        jbest = jtrainer.end_of_epoch_outputs(str(tmp_path / "j"), jstate, jcfg, epoch, last, jbest)
        assert tbest == jbest
    tnames = sorted(p.name.removesuffix(".pt") for p in (tmp_path / "t").glob("*.pt"))
    jnames = sorted(p.name for p in (tmp_path / "j").iterdir()
                    if p.is_dir() and (tmp_path / "j" / f"{p.name}.meta.json").exists())
    assert tnames == jnames == ["best_model", "epoch_1", "epoch_3", "epoch_4", "final_model"]
    payload, meta = ttrainer.load_checkpoint(str(tmp_path / "t" / "best_model"))
    assert meta["epoch"] == 3 and torch.equal(payload["opt_state"]["m"], torch.ones(1))


def test_try_resume_restores_and_resets_the_ief_embedding(small, tmp_path):
    """A checkpoint written by save_checkpoint comes back whole (parameters,
    statistics, optimizer state, epoch, history); with
    reset_ief_token_embedding the IEF head's estimate-embedding parameters
    keep the model's fresh values, as the JAX package's migration flag does."""
    s = small
    trained = s["port_model"]()
    state = ttrainer.TrainState(trained.state_dict(), opt_state={"m": torch.ones(2)}, epoch=3,
                                history=[{"epoch": 3, "loss": 1.5}])
    ttrainer.save_checkpoint(str(tmp_path), state, s["tcfg"], "final_model")
    for reset in (False, True):
        fresh = s["port_model"]()
        with torch.no_grad():
            for p in fresh.parameters():
                p.add_(1.0)
        before = {k: v.clone() for k, v in fresh.state_dict().items()}
        got, start = ttrainer.try_resume(str(tmp_path), "final_model",
                                         ttrainer.TrainState(fresh.state_dict()), fresh,
                                         reset_ief_token_embedding=reset)
        assert start == 4 and got.history == state.history and torch.equal(got.opt_state["m"], torch.ones(2))
        kept = {k for k in before if any(t in k for t in ("init_estimate", "estimate_embed",
                                                          "estimate_norm"))}
        assert kept and all(k.startswith("head.") for k in kept)
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, before[k] if (reset and k in kept) else trained.state_dict()[k]), k
    assert ttrainer.try_resume(str(tmp_path), None, state, trained) == (state, 0)


def test_plot_training_history_without_matplotlib(monkeypatch, tmp_path):
    from smilify_tpu_torch.utils.image_io import read_png

    hist = [{"epoch": i, "loss": 1.0 / (i + 1), "lr": 1e-3, "loss_a": 0.5, "ief_d": 0.1}
            for i in range(3)]
    block_plot_libraries(monkeypatch)
    written = ttrainer.plot_training_history(hist, str(tmp_path / "plots"))
    assert {os.path.basename(p): read_png(p).shape for p in written} == {
        "training_history.png": (480, 840, 4), "lr_schedule.png": (360, 840, 4),
        "loss_components.png": (480, 960, 4), "ief_deltas.png": (480, 960, 4)}
    assert ttrainer.plot_training_history([], str(tmp_path / "none")) == []
