"""``serve.py::predictor``'s CUDA-graph replay.

On the CPU every call runs eagerly: the outputs are the model's and the
decode's as called directly, the calls count ``infer.graph.eager`` and
nothing else, no two calls' outputs share memory, and ``utils/graphs.py``'s
:func:`graph_key` tells apart batches of another shape, dtype, device or
input name. ``filled`` (how
``device_constant`` makes a constant while a graph captures, without a
host copy) rounds as ``torch.tensor`` does.

On a card (marker ``card``; this file imports no JAX, so it runs where
there is none; ``tests`` is bound to this directory first, since the card's
machine has another package of that name installed)::

    python -c "import sys, types, pytest; t = types.ModuleType('tests'); \\
        t.__path__ = ['tests']; sys.modules['tests'] = t; sys.exit(pytest.main( \\
        ['tests/test_torch_predictor_graph.py', '--noconftest', '-m', 'card', '-v']))"

a key's first call runs eagerly, its second captures and replays and later
ones replay; each graphed output is bitwise equal to an eager call's on the
same batch, outputs already returned stay as they were, and a short last
batch runs eagerly. Single-view (ResNet-50 under bf16 autocast) and
multi-view (``unet_micro`` under bf16 autocast, three views).
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import pytest
import torch

from smilify_tpu_torch import serve
from smilify_tpu_torch._device import device_constant, filled
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.models.multiview import decode_multiview_predictions
from smilify_tpu_torch.models.regressor import decode_predictions, float32_region
from smilify_tpu_torch.models.weight_port import build_model
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl
from smilify_tpu_torch.train import config as tconfig
from smilify_tpu_torch.utils import graphs, monitoring

MODES = ["single_view", "multi_view"]
VIEWS = 3
COUNTERS = ("infer.graph.eager", "infer.graph.captures", "infer.graph.replays")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on one, run this file as its docstring says")
    return torch.device("cuda", 0)


def _toy(tmp_path, mode, device, backbone="unet_micro", res=32, mixed=False):
    """(model, regressor config, spec) as ``load_model_from_checkpoint``
    leaves them, every parameter moved off its initialization (the heads'
    output layers start at zero, which would make every prediction the
    same)."""
    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), toy_model_spec(8, 6, 3, device="cpu"))
    over = {"smal_model.smal_file": pkl, "model.backbone_name": backbone,
            "model.input_resolution": res, "model.transformer_depth": 1,
            "model.transformer_heads": 2, "model.transformer_dim_head": 8,
            "model.transformer_mlp_dim": 16, "multiview.num_views_to_use": VIEWS,
            "multiview.cross_attention_heads": 2, "multiview.cross_attention_layers": 1,
            "training.use_mixed_precision": mixed}
    cfg = tconfig.load_config(None, overrides=over, mode=mode)
    spec = tconfig.resolve_model_spec(cfg, device=device)
    rcfg = cfg.regressor_config(spec)
    gen = torch.Generator().manual_seed(0)
    model = build_model(rcfg, img_size=res)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, rcfg, spec


def _batch(mode, n, res, device, seed):
    gen = torch.Generator().manual_seed(seed)
    if mode == "single_view":
        return {"image": torch.rand(n, res, res, 3, generator=gen).to(device)}
    mask = torch.ones(n, VIEWS, dtype=torch.bool)
    mask[0, -1] = False
    return {"images": torch.rand(n, VIEWS, res, res, 3, generator=gen).to(device),
            "view_mask": mask.to(device),
            "camera_indices": torch.arange(VIEWS).repeat(n, 1).to(device)}


@torch.no_grad()
def _direct(model, rcfg, spec, mode, batch):
    """The model and the decode called directly, as ``predict`` ran before
    it could replay a graph."""
    if mode == "single_view":
        raw, _ = model(batch["image"])
    else:
        raw, _ = model(batch["images"], batch["view_mask"], batch["camera_indices"])
    with float32_region(spec.device):
        if mode == "single_view":
            return decode_predictions(rcfg, raw, spec)
        return decode_multiview_predictions(rcfg, raw, spec)


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _counters():
    c = monitoring.summary()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("mode", MODES)
def test_cpu_predictor_is_eager_and_unchanged(tmp_path, mode):
    cpu = torch.device("cpu")
    model, rcfg, spec = _toy(tmp_path, mode, cpu)
    predict = serve.predictor(model, rcfg, spec, mode == "multi_view")
    batches = [_batch(mode, 4, 32, cpu, s) for s in (1, 1, 2, 3)] + [_batch(mode, 3, 32, cpu, 4)]
    monitoring.reset()
    with monitoring.recording():
        outs = [predict(b) for b in batches]
        counters = _counters()
    monitoring.reset()
    assert counters == {"infer.graph.eager": 5, "infer.graph.captures": 0,
                        "infer.graph.replays": 0}
    for b, out in zip(batches, outs):
        _assert_equal(out, _direct(model, rcfg, spec, mode, b))
    assert not torch.equal(outs[0]["global_rot"], outs[2]["global_rot"])


@pytest.mark.parametrize("mode", MODES)
def test_outputs_of_two_calls_do_not_alias(tmp_path, mode):
    cpu = torch.device("cpu")
    model, rcfg, spec = _toy(tmp_path, mode, cpu)
    predict = serve.predictor(model, rcfg, spec, mode == "multi_view")
    batch = _batch(mode, 4, 32, cpu, 1)
    first, second = predict(batch), predict(batch)
    ptrs = {v.untyped_storage().data_ptr() for v in first.values()}
    assert not ptrs & {v.untyped_storage().data_ptr() for v in second.values()}


@pytest.mark.parametrize("change", ["same", "shape", "dtype", "device", "another_input",
                                    "another_name"])
def test_graph_key_separates_batches(change):
    image, mask = torch.zeros(4, 8, 8, 3), torch.ones(4, 3, dtype=torch.bool)
    base = {"image": image, "mask": mask}
    other = {
        "same": {"image": torch.ones(4, 8, 8, 3), "mask": torch.zeros(4, 3, dtype=torch.bool)},
        "shape": {"image": torch.zeros(3, 8, 8, 3), "mask": torch.ones(3, 3, dtype=torch.bool)},
        "dtype": {"image": torch.zeros(4, 8, 8, 3, dtype=torch.float64), "mask": mask},
        "device": {"image": torch.empty(4, 8, 8, 3, device="meta"), "mask": mask},
        "another_input": {"image": image, "mask": torch.ones(4, 3, dtype=torch.int64)},
        "another_name": {"image": image, "view_mask": mask},
    }[change]
    key = graphs.graph_key
    assert (key(base) == key(other)) == (change == "same")
    assert key(base) == key({k: x.clone() for k, x in base.items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
def test_filled_constants_round_as_torch_tensor(dtype):
    cpu = torch.device("cpu")
    for values in ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), (1.0, 0, 0, 0, 1.0, 0),
                   (0.0, 0, 2.7)):
        want = torch.tensor(values, dtype=dtype)
        for got in (filled(values, dtype, cpu), device_constant(values, dtype, cpu)):
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(got, want), values


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
def test_card_replay_is_bitwise_eager(tmp_path, card, mode):
    if mode == "single_view":
        n, res = 8, 64
        model, rcfg, spec = _toy(tmp_path, mode, card, backbone="resnet50", res=res, mixed=True)
    else:
        n, res = 4, 32
        model, rcfg, spec = _toy(tmp_path, mode, card, mixed=True)
    assert rcfg.compute_dtype == torch.bfloat16
    mv = mode == "multi_view"
    predict = serve.predictor(model, rcfg, spec, mv)
    batches = [_batch(mode, n, res, card, s) for s in range(4)]
    # the eager reference: a fresh predictor's first call with a key runs eagerly
    eager = [serve.predictor(model, rcfg, spec, mv)(b) for b in batches]
    monitoring.reset()
    with monitoring.recording():
        outs = [predict(b) for b in batches]
        assert _counters() == {"infer.graph.eager": 1, "infer.graph.captures": 1,
                               "infer.graph.replays": 3}
        kept = [{k: v.clone() for k, v in o.items()} for o in outs]
        short = _batch(mode, n - 1, res, card, 9)
        short_out = predict(short)
        assert _counters() == {"infer.graph.eager": 2, "infer.graph.captures": 1,
                               "infer.graph.replays": 3}
        again = predict(batches[1])
        assert _counters()["infer.graph.replays"] == 4
    monitoring.reset()
    torch.cuda.synchronize(card)
    for out, ref, keep in zip(outs, eager, kept):
        _assert_equal(out, ref)
        _assert_equal(out, keep)      # a later call overwrote nothing returned
    assert not torch.equal(outs[1]["global_rot"], outs[2]["global_rot"])
    _assert_equal(again, eager[1])
    _assert_equal(short_out, serve.predictor(model, rcfg, spec, mv)(short))
