"""``train/trainer.py::make_train_step``'s CUDA-graph replay and the state
it keeps.

On the CPU every step runs eagerly and counts ``train.graph.eager`` and
nothing else; the second step makes no copy from host data and reads
nothing back (what a capture refuses); ``Optimizer``'s state updated in
place gives bitwise the parameters, ``notfinite_count``,
``total_notfinite`` and ``grad_norm`` of the rebinding it replaced (kept
here), over 20 steps with a non-finite batch and a run of more than
``MAX_CONSECUTIVE_ERRORS``; the constants that ``core/lbs.py`` and
``models/regressor.py``'s camera keep per device equal ``torch.tensor``'s,
and ``torch.export`` keeps none of its own tensors among them;
``graph_key`` tells apart another batch size.

On a card (marker ``card``; this file imports no JAX, so it runs where
there is none; ``tests`` is bound to this directory first, since the card's
machine has another package of that name installed)::

    python -c "import sys, types, pytest; t = types.ModuleType('tests'); \\
        t.__path__ = ['tests']; sys.modules['tests'] = t; sys.exit(pytest.main( \\
        ['tests/test_torch_train_graph.py', '--noconftest', '-m', 'card', '-v']))"

a single-view step (ResNet-50 under bf16 autocast) graphed from its third
call is bitwise the eager step over 6 steps (parameters, BatchNorm's
buffers, Adam's moments and step, losses); losses returned earlier stay as
they were; a half batch gets its own key; ``Optimizer``'s skip holds under
replay; a multi-view step, which waits on the host, stays eager with its
spans; dropping a step function frees its graph's memory but cuBLAS's
workspace for the capture's stream.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import copy
import gc

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from smilify_tpu_torch._device import shared_constant
from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn
from smilify_tpu_torch.core import lbs
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.models.regressor import batched_camera, compute_batch_loss
from smilify_tpu_torch.models.weight_port import build_model
from smilify_tpu_torch.render.cameras import default_camera
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
from smilify_tpu_torch.train import config as tconfig
from smilify_tpu_torch.train import trainer
from smilify_tpu_torch.utils import graphs, monitoring

COUNTERS = ("train.graph.eager", "train.graph.captures", "train.graph.replays")
TARGETS = ("global_rot", "joint_rot", "betas", "trans", "keypoints_2d", "kp_visibility")
J, B = 6, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on one, run this file as its docstring says")
    return torch.device("cuda", 0)


def _config(tmp_path, mode, backbone="unet_micro", res=32, mixed=False, views=3, **over):
    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), toy_model_spec(8, J, B, device="cpu"))
    over = {"smal_model.smal_file": pkl, "model.backbone_name": backbone,
            "model.input_resolution": res, "model.transformer_depth": 1,
            "model.transformer_heads": 2, "model.transformer_dim_head": 8,
            "model.transformer_mlp_dim": 16, "multiview.num_views_to_use": views,
            "multiview.cross_attention_heads": 2, "multiview.cross_attention_layers": 1,
            "training.use_mixed_precision": mixed, **over}
    return tconfig.load_config(None, overrides=over, mode=mode)


def _single_view(tmp_path, device, backbone="unet_micro", res=32, mixed=False,
                 optimizer="plain"):
    """(model, optimizer, step maker) of a single-view regressor in train
    mode; ``make()`` builds a new step over the same model and optimizer."""
    cfg = _config(tmp_path, "single_view", backbone, res, mixed)
    spec = tconfig.resolve_model_spec(cfg, device=device)
    rcfg = cfg.regressor_config(spec)
    torch.manual_seed(0)
    model = build_model(rcfg, img_size=res).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    weights = cfg.get_loss_weights_for_epoch(0)
    apply_fn = make_singleview_apply_fn(rcfg, spec)

    def loss_fn(preds, batch):
        return compute_batch_loss(spec, rcfg, preds, {k: batch[k] for k in TARGETS}, weights,
                                  image_size=(res, res))

    opt = (trainer.PlainAdam(model, 1e-3) if optimizer == "plain"
           else trainer.build_optimizer(cfg, 1e-3, False, model))
    return model, opt, lambda: trainer.make_train_step(model, apply_fn, loss_fn, opt)


def _batch(n, res, device, seed):
    g = torch.Generator().manual_seed(seed)
    b = {"image": torch.rand(n, res, res, 3, generator=g),
         "global_rot": 0.2 * torch.randn(n, 3, generator=g),
         "joint_rot": 0.1 * torch.randn(n, J - 1, 3, generator=g),
         "betas": 0.3 * torch.randn(n, B, generator=g),
         "trans": 0.05 * torch.randn(n, 3, generator=g),
         "keypoints_2d": 0.2 + 0.6 * torch.rand(n, J, 2, generator=g),
         "kp_visibility": torch.ones(n, J)}
    return {k: v.to(device) for k, v in b.items()}


def _counters():
    c = monitoring.summary()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _state(model, opt):
    """Every tensor a step changes: parameters, buffers, Adam's state."""
    out = {f"model.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    for i, p in enumerate(opt.params):
        for k, v in opt.inner.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_cpu_steps_are_eager(tmp_path):
    cpu = torch.device("cpu")
    model, opt, make = _single_view(tmp_path, cpu)
    step = make()
    batches = [_batch(4, 32, cpu, s) for s in (1, 2, 3, 4)] + [_batch(2, 32, cpu, 5)]
    monitoring.reset()
    with monitoring.recording():
        losses = [step(b)[0] for b in batches]
        counters = _counters()
        spans = monitoring.summary()["spans"]
    monitoring.reset()
    assert counters == {"train.graph.eager": 5, "train.graph.captures": 0,
                        "train.graph.replays": 0}
    for name in ("train.step", "model.decode", "train.loss", "train.backward", "train.update"):
        assert spans[name]["count"] == 5, name
    assert len({v.untyped_storage().data_ptr() for v in losses}) == 5
    assert all(torch.isfinite(v) for v in losses)


class _HostTraffic(TorchFunctionMode):
    """Calls that, on a card, copy host data to the device or read the
    device back: a tensor made from host values, a scalar read."""

    READS = {"item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__", "__index__",
             "nonzero"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        made = name in ("tensor", "from_numpy") or (
            name == "as_tensor" and not isinstance(args[0], torch.Tensor))
        if made or name in self.READS:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


class _HostOps(TorchDispatchMode):
    """The same below the Python API: host values lifted into a tensor (a
    list index, ``torch.tensor`` inside a library), a scalar read, an
    operation whose output size the host must read."""

    OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
           "aten.is_nonzero", "aten.equal", "aten.unique", "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("optimizer", ["plain", "clip_and_skip"])
def test_second_step_copies_nothing_from_the_host(tmp_path, optimizer):
    cpu = torch.device("cpu")
    _, _, make = _single_view(tmp_path, cpu, optimizer=optimizer)
    step = make()
    step(_batch(4, 32, cpu, 1))
    batch = _batch(4, 32, cpu, 2)
    with _HostTraffic() as traffic, _HostOps() as ops:
        step(batch)
    assert traffic.seen == [] and ops.seen == []


def _assert_bitwise(got, want, what):
    """Equal element by element, NaN where NaN (bitwise but for NaN's payload)."""
    assert got.dtype == want.dtype, what
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=str(what))


def _rebinding_step(opt, state):
    """``Optimizer.step``'s logic as it was before its state was kept in
    place: each step rebinds the counts, the norm and Adam's flag."""
    for p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in opt.params]
    finite = torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < opt.max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * opt.max_norm))
    state["notfinite_count"] = torch.where(finite, torch.zeros_like(state["notfinite_count"]),
                                           state["notfinite_count"] + 1)
    state["total_notfinite"] = state["total_notfinite"] + (~finite).to(torch.int32)
    apply = finite | (state["notfinite_count"] > trainer.MAX_CONSECUTIVE_ERRORS)
    state["grad_norm"] = g_norm
    opt.inner.found_inf = (~apply).to(torch.float32)
    opt.inner.step()


def test_in_place_optimizer_state_is_bitwise_the_rebinding(tmp_path):
    cfg = _config(tmp_path, "single_view", **{"optimizer.gradient_clip_norm": 0.5})
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    twin = copy.deepcopy(model)
    opt = trainer.build_optimizer(cfg, 1e-2, False, model)
    old = trainer.build_optimizer(cfg, 1e-2, False, twin)
    state = {k: getattr(old, k).clone()
             for k in ("notfinite_count", "total_notfinite", "grad_norm")}
    kept = {k: getattr(opt, k) for k in state}
    # finite, one non-finite, finite, then 17 non-finite in a row, the 17th applied
    bad = {1} | set(range(3, 4 + trainer.MAX_CONSECUTIVE_ERRORS))
    g = torch.Generator().manual_seed(3)
    for i in range(4 + trainer.MAX_CONSECUTIVE_ERRORS):
        x = torch.randn(32, 8, generator=g)
        if i in bad:
            x[i % 32, i % 8] = float("nan") if i % 2 else float("inf")
        for net, o in ((model, opt), (twin, old)):
            for p in o.params:
                p.grad = None
            net(x).square().mean().backward()
        opt.step()
        _rebinding_step(old, state)
        for (name, p), q in zip(model.named_parameters(), twin.parameters()):
            _assert_bitwise(p, q, (i, name))
        for k, v in state.items():
            assert getattr(opt, k) is kept[k], k          # the same tensor, updated in place
            _assert_bitwise(kept[k], v, (i, k))
    assert int(opt.total_notfinite) == len(bad) == 18
    assert int(opt.notfinite_count) == trainer.MAX_CONSECUTIVE_ERRORS + 1
    assert not all(torch.isfinite(p).all() for p in model.parameters())     # applied


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kept_constants_equal_torch_tensor(dtype):
    cpu = torch.device("cpu")
    for values in (lbs._UNREAL_Y_FLIP, lbs._BOTTOM_ROW, (224, 224), (32, 48), (1.0,)):
        got = shared_constant(values, dtype, cpu)
        want = torch.tensor(values, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want), values
        assert shared_constant(values, dtype, cpu) is got       # made once
    R, T, fov = torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3), torch.full((2,), 50.0)
    cam, ref = batched_camera(R, T, fov), default_camera(device=cpu)
    assert cam.aspect_ratio.shape == ref.aspect_ratio.shape
    assert cam.aspect_ratio.dtype == ref.aspect_ratio.dtype
    assert torch.equal(cam.aspect_ratio, ref.aspect_ratio)
    assert (cam.znear, cam.zfar) == (ref.znear, ref.zfar)


def test_kept_constants_stay_plain_tensors_under_export():
    values = (3.25, -4.5)       # made by no other test

    class Scale(torch.nn.Module):
        def forward(self, x):
            return x * shared_constant(values, x.dtype, x.device)

    x = torch.ones(2)
    program = torch.export.export(Scale(), (x,))
    const = shared_constant(values, torch.float32, torch.device("cpu"))
    assert type(const) is torch.Tensor and torch.equal(const, torch.tensor(values))
    assert type(Scale()(x)) is torch.Tensor
    assert torch.equal(program.module()(x), torch.tensor(values))


def test_graph_key_tells_apart_another_batch_size():
    cpu = torch.device("cpu")
    full, half = _batch(4, 32, cpu, 1), _batch(2, 32, cpu, 1)
    assert graphs.graph_key(full) != graphs.graph_key(half)
    assert graphs.graph_key(full) == graphs.graph_key(_batch(4, 32, cpu, 2))


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

RES, N = 64, 8


def _resnet(tmp_path, card, optimizer="plain"):
    return _single_view(tmp_path, card, "resnet50", RES, True, optimizer)


@pytest.mark.card
def test_card_graphed_steps_are_bitwise_eager(tmp_path, card):
    batches = [_batch(N, RES, card, s) for s in range(6)]
    model, opt, make = _resnet(tmp_path, card)
    # the eager reference: a fresh step's first call with a key runs eagerly
    eager = [make()(b) for b in batches]
    want = _state(model, opt)
    model, opt, make = _resnet(tmp_path, card)
    step = make()
    monitoring.reset()
    with monitoring.recording():
        outs = [step(b) for b in batches[:3]]
        assert _counters() == {"train.graph.eager": 2, "train.graph.captures": 1,
                               "train.graph.replays": 1}
        kept = [(loss.clone(), {k: v.clone() for k, v in objs.items()}) for loss, objs in outs]
        outs += [step(b) for b in batches[3:]]
        assert _counters()["train.graph.replays"] == 4
    monitoring.reset()
    torch.cuda.synchronize(card)
    _assert_same(_state(model, opt), want)
    for (loss, objs), (ref_loss, ref_objs) in zip(outs, eager):
        assert torch.equal(loss, ref_loss)
        _assert_same(objs, ref_objs)
    for (loss, objs), (kloss, kobjs) in zip(outs, kept):
        assert torch.equal(loss, kloss)                 # a later replay overwrote nothing returned
        _assert_same(objs, kobjs)
    norm = next(m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert int(norm.num_batches_tracked) == 6
    assert float(opt.inner.state[opt.params[0]]["step"]) == 6.0


@pytest.mark.card
def test_card_half_batch_gets_its_own_key(tmp_path, card):
    _, _, make = _resnet(tmp_path, card)
    step = make()
    monitoring.reset()
    with monitoring.recording():
        for s in range(3):
            step(_batch(N, RES, card, s))
        step(_batch(N // 2, RES, card, 9))
        assert _counters() == {"train.graph.eager": 3, "train.graph.captures": 1,
                               "train.graph.replays": 1}
        for s in range(2):
            step(_batch(N // 2, RES, card, 10 + s))
        step(_batch(N, RES, card, 20))
        assert _counters() == {"train.graph.eager": 4, "train.graph.captures": 2,
                               "train.graph.replays": 3}
    monitoring.reset()


@pytest.mark.card
def test_card_skip_holds_under_replay(tmp_path, card):
    model, opt, make = _resnet(tmp_path, card, optimizer="clip_and_skip")
    step = make()
    for s in range(4):          # eager, eager, capture, replay
        step(_batch(N, RES, card, s))
    for k in (1, 2):
        bad = _batch(N, RES, card, 10 + k)
        bad["betas"][0, 0] = float("nan")
        before = [p.detach().clone() for p in opt.params]
        adam = float(opt.adam_step())
        loss, _ = step(bad)
        assert not torch.isfinite(loss)
        assert all(torch.equal(a, p) for a, p in zip(before, opt.params))
        assert float(opt.adam_step()) == adam
        assert int(opt.notfinite_count) == k and int(opt.total_notfinite) == k
    before = [p.detach().clone() for p in opt.params]
    step(_batch(N, RES, card, 30))
    assert int(opt.notfinite_count) == 0 and int(opt.total_notfinite) == 2
    assert not all(torch.equal(a, p) for a, p in zip(before, opt.params))


@pytest.mark.card
def test_card_multiview_step_waits_on_the_host_and_stays_eager(tmp_path, card):
    from smilify_tpu_torch.data.synthetic import synthesize_multiview
    from smilify_tpu_torch.train import multiview_setup

    views, res = 3, 32
    cfg = _config(tmp_path, "multi_view", mixed=True, views=views)
    spec = tconfig.resolve_model_spec(cfg, device=card)
    rcfg = cfg.regressor_config(spec)
    model = build_model(rcfg, img_size=res).to(card)
    apply_fn = multiview_setup.make_multiview_apply_fn(rcfg, spec, (res, res))
    loss_fn = multiview_setup.make_multiview_loss_fn(spec, rcfg, cfg.get_loss_weights_for_epoch(0),
                                                     (res, res))
    opt = trainer.build_optimizer(cfg, 1e-4, False, model)
    step = trainer.make_train_step(model, apply_fn, loss_fn, opt)
    samples = synthesize_multiview(toy_model_spec(8, J, B, device=card), 8, views, res,
                                   render_images=False, device=card)
    cache = trainer.DeviceDataCache(samples, card)

    def batch(i):
        b = cache.batch(list(range(4 * i, 4 * i + 4)))
        b["view_mask"] = torch.ones(4, views, dtype=torch.bool, device=card)
        b["camera_indices"] = torch.arange(views, device=card).repeat(4, 1)
        return b

    monitoring.reset()
    with monitoring.recording():
        losses = [step(batch(i % 2))[0] for i in range(4)]
        counters, spans = _counters(), monitoring.summary()["spans"]
    monitoring.reset()
    assert counters == {"train.graph.eager": 4, "train.graph.captures": 0,
                        "train.graph.replays": 0}
    for name in ("train.step", "model.backbone", "model.head", "train.loss", "train.backward",
                 "train.update"):
        assert spans[name]["count"] == 4, name
    assert all(torch.isfinite(v) for v in losses)


@pytest.mark.card
def test_card_dropping_a_step_frees_its_graph(tmp_path, card):
    model, opt, make = _resnet(tmp_path, card)
    step = make()
    for s in range(2):
        step(_batch(N, RES, card, s))
    batch = _batch(N, RES, card, 5)
    gc.collect()
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(card)
    for _ in range(3):
        step(batch)             # the capture, then replays
    torch.cuda.synchronize(card)
    held = torch.cuda.memory_reserved(card)
    assert held > before
    del step
    for p in opt.params:        # the gradients the graph assigned live in its pool
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved(card)
    # what stays is cuBLAS's workspace for the capture's stream, made in the
    # graph's pool and kept by cuBLAS (10 MiB on an H100)
    assert after - before <= 16 * 2**20 < held - before, (before, held, after)
