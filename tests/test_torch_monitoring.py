"""The port's span-and-counter recorder (``smilify_tpu_torch.utils.monitoring``)
on the CPU: nesting, parents and self time; the shared no-op while nothing
records; recording under ``torch.profiler`` with the spans among the
profiler's host events; counters; the spans of the fitter's stage driver,
step and raster (the kernels' plain versions) and of the train step; the
fit unchanged by recording; and the benchmark's six span readers
(``portbench/metrics``) on a recorder filled with known spans.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import types

import numpy as np
import pytest
import torch

from portbench import harness
from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.fitter import fitter as tfit
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS
from smilify_tpu_torch.utils import monitoring

SIZE = (64, 64)
TRAIN_SPANS = ("data.batch", "train.step", "model.backbone", "model.head", "model.decode",
               "train.loss", "train.backward", "train.update")


@pytest.fixture(autouse=True)
def fresh_recorder():
    monitoring.reset()
    yield
    monitoring.reset()


def _by_name(log):
    out = {}
    for rec in log:
        out.setdefault(rec.name, []).append(rec)
    return out


def _parents(log):
    """{span name: the set of its parents' names}."""
    names = {rec.index: rec.name for rec in log}
    out = {}
    for rec in log:
        out.setdefault(rec.name, set()).add(names.get(rec.parent))
    return out


def test_spans_nest_record_their_parent_and_self_time():
    pm = monitoring.PerformanceMonitor()
    with pm.recording():
        with pm.span("outer"):
            with pm.span("inner"):
                with pm.span("leaf"):
                    sum(range(1000))
            with pm.span("inner"):
                sum(range(1000))
            sum(range(1000))
    recs = _by_name(pm.log)
    (outer,), inner, (leaf,) = recs["outer"], recs["inner"], recs["leaf"]
    assert outer.parent == -1
    assert [r.parent for r in inner] == [outer.index] * 2 and leaf.parent == inner[0].index
    assert all(r.end_ns >= r.start_ns for r in pm.log)
    assert outer.start_ns <= inner[0].start_ns and inner[1].end_ns <= outer.end_ns

    def dur(r):
        return r.end_ns - r.start_ns

    s = pm.summary()["spans"]
    assert {k: v["count"] for k, v in s.items()} == {"outer": 1, "inner": 2, "leaf": 1}
    assert s["outer"]["host_s"] == dur(outer) / 1e9
    assert s["outer"]["self_s"] == (dur(outer) - dur(inner[0]) - dur(inner[1])) / 1e9
    assert s["inner"]["host_s"] == (dur(inner[0]) + dur(inner[1])) / 1e9
    assert s["inner"]["self_s"] == (dur(inner[0]) - dur(leaf) + dur(inner[1])) / 1e9
    assert s["leaf"]["self_s"] == s["leaf"]["host_s"] == dur(leaf) / 1e9
    assert all(v["device_s"] is None for v in s.values())     # no card


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not torch._C._autograd._profiler_enabled()
    a, b = monitoring.span("fit.step"), monitoring.span("raster.setup")
    assert a is b and type(a).__name__ == "_NoSpan"
    with a:
        with monitoring.span("fit.update"):
            monitoring.count("raster.exact_fwd.launches")
    assert monitoring.summary() == {"spans": {}, "counters": {}}
    assert len(monitoring.MONITOR.log) == 0
    with monitoring.recording():
        assert monitoring.span("fit.step") is not a
    assert monitoring.span("fit.step") is a


def test_the_profiler_turns_recording_on_and_carries_the_spans():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monitoring.span("fit.step"):
            with monitoring.span("fit.losses"):
                torch.ones(8) * 2
            monitoring.count("raster.worklist_fwd.launches", 3)
    s = monitoring.summary()
    assert {k: v["count"] for k, v in s["spans"].items()} == {"fit.step": 1, "fit.losses": 1}
    assert s["counters"] == {"raster.worklist_fwd.launches": 3}
    host = [e for e in prof.events() if e.name in ("fit.step", "fit.losses")]
    assert sorted(e.name for e in host) == ["fit.losses", "fit.step"]
    step = next(e for e in host if e.name == "fit.step")
    losses = next(e for e in host if e.name == "fit.losses")
    assert step.time_range.start <= losses.time_range.start
    assert losses.time_range.end <= step.time_range.end
    # the profile is over: nothing more is recorded
    with monitoring.span("fit.step"):
        pass
    assert monitoring.summary()["spans"]["fit.step"]["count"] == 1


def test_counters_count_only_while_recording():
    monitoring.count("peak.fma.launches")
    with monitoring.recording():
        monitoring.count("peak.fma.launches")
        monitoring.count("raster.exact_fwd.frames", 4)
        with monitoring.recording():           # nested blocks: still one recorder
            monitoring.count("peak.fma.launches")
        monitoring.count("peak.fma.launches")
    monitoring.count("peak.fma.launches")
    assert monitoring.summary()["counters"] == {"peak.fma.launches": 3,
                                                "raster.exact_fwd.frames": 4}
    monitoring.reset()
    assert monitoring.summary()["counters"] == {}


@pytest.fixture(scope="module")
def fit_inputs():
    spec = toy_model_spec(10, 6, 3, device="cpu")
    data = tfit.synthetic_fit_data(spec, 2, SIZE)
    return spec, data


def _fit(spec, data, cap, iters=4, chunk=2):
    fitter = tfit.SmalFitter(spec, data, SIZE, approx_max_faces=cap, device="cpu")
    fitter.run_stage(2, OPT_WEIGHTS[2]._replace(num_iters=iters), callback=lambda *a: None,
                     chunk=chunk)
    return fitter


@pytest.mark.parametrize("cap", [None, 24], ids=["exact", "worklist"])
def test_run_stage_records_the_fitter_spans(fit_inputs, cap):
    spec, data = fit_inputs
    with monitoring.recording():
        _fit(spec, data, cap, iters=4, chunk=2)
    counts = {k: v["count"] for k, v in monitoring.summary()["spans"].items()}
    assert counts == {"fit.stage": 1, "fit.step": 4, "fit.smil_forward": 4, "fit.project": 4,
                      "fit.losses": 8, "fit.backward": 4, "fit.update": 4, "fit.readback": 2,
                      "raster.setup": 4, "raster.fwd": 4, "raster.bwd": 4}
    parents = _parents(monitoring.MONITOR.log)
    assert parents["fit.stage"] == {None}
    assert parents["fit.step"] == parents["fit.readback"] == {"fit.stage"}
    for name in ("fit.smil_forward", "fit.project", "fit.losses", "fit.backward", "fit.update",
                 "raster.setup", "raster.fwd"):
        assert parents[name] == {"fit.step"}, name
    assert parents["raster.bwd"] == {"fit.backward"}
    # the plain versions launch no kernel
    assert monitoring.summary()["counters"] == {}


def test_fitted_parameters_are_bitwise_equal_with_recording_on_and_off(fit_inputs):
    spec, data = fit_inputs
    off = _fit(spec, data, 24)
    with monitoring.recording():
        on = _fit(spec, data, 24)
    assert monitoring.summary()["spans"]["fit.step"]["count"] == 4
    for k in tfit.FitParams.fields():
        assert torch.equal(getattr(on.params, k), getattr(off.params, k)), k


def test_train_step_records_its_spans():
    from smilify_tpu_torch.train.singleview_setup import make_singleview_apply_fn
    from smilify_tpu_torch.models.regressor import (
        RegressorConfig,
        SMILRegressor,
        compute_batch_loss,
    )
    from smilify_tpu_torch.train.trainer import DeviceDataCache, PlainAdam, make_train_step

    torch.manual_seed(0)
    spec = toy_model_spec(8, 6, 3, device="cpu")
    J, B, res = spec.n_joints, spec.n_betas, 32
    rcfg = RegressorConfig(backbone="unet_micro", n_pose=J - 1, n_betas=B, n_joints=J,
                           decoder_dim=16, decoder_depth=1, decoder_heads=2, ief_iters=1,
                           compute_dtype=torch.float32)
    model = SMILRegressor(rcfg, img_size=res)
    rng = np.random.default_rng(0)
    samples = [{"image": rng.uniform(0, 1, (res, res, 3)).astype(np.float32),
                "global_rot": rng.normal(0, 0.1, 3).astype(np.float32),
                "joint_rot": rng.normal(0, 0.1, (J - 1, 3)).astype(np.float32),
                "betas": rng.normal(0, 0.1, B).astype(np.float32),
                "trans": rng.normal(0, 0.1, 3).astype(np.float32),
                "keypoints_2d": rng.uniform(0.2, 0.8, (J, 2)).astype(np.float32),
                "kp_visibility": np.ones(J, np.float32)} for _ in range(4)]
    cache = DeviceDataCache(samples, "cpu")

    def loss_fn(preds, batch):
        targets = {k: v for k, v in batch.items() if k != "image"}
        return compute_batch_loss(spec, rcfg, preds, targets, {"keypoint_2d": 1.0},
                                  image_size=(res, res))

    step = make_train_step(model, make_singleview_apply_fn(rcfg, spec), loss_fn,
                           PlainAdam(model, 1e-3))
    with monitoring.recording():
        loss, _ = step(cache.batch([0, 2]))
    assert torch.isfinite(loss)
    counts = {k: v["count"] for k, v in monitoring.summary()["spans"].items()}
    assert {k: counts.get(k) for k in TRAIN_SPANS} == dict.fromkeys(TRAIN_SPANS, 1)
    parents = _parents(monitoring.MONITOR.log)
    assert parents["data.batch"] == parents["train.step"] == {None}
    for name in ("model.backbone", "model.head", "model.decode", "train.loss", "train.backward",
                 "train.update"):
        assert parents[name] == {"train.step"}, name
    # the loss's SMIL forward (the 2D keypoints) is forward_model's span
    assert parents["infer.smil_forward"] == {"train.loss"}


_STREAM = object()


class _Clock:
    """A host clock that moves only when told, and CUDA-like events on it."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def advance(self, ms):
        self.ns += int(ms * 1e6)

    def event_pair(self):
        return _STREAM, _Event(self), _Event(self)


class _Event:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def record(self, stream):
        assert stream is _STREAM
        self.t = self.clock.ns

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_device_stream_time_from_an_event_pair_on_the_current_stream(monkeypatch):
    """On a card a span records two events on the current stream; their
    interval is its device-stream time, folded in once they complete
    (``query``) or when read."""
    clock = _Clock()
    made = []

    def event(enable_timing):
        assert enable_timing
        made.append(_Event(clock))
        return made[-1]

    monkeypatch.setattr(monitoring, "time", types.SimpleNamespace(
        perf_counter_ns=clock.perf_counter_ns))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _STREAM)
    monkeypatch.setattr(monitoring.MONITOR, "FOLD_EVERY", 1)      # fold as each span ends
    monkeypatch.setattr(torch.cuda, "Event", event)
    with monitoring.recording():
        with monitoring.span("raster.setup"):
            clock.advance(2.0)
        assert monitoring.summary()["spans"]["raster.setup"]["device_s"] == pytest.approx(2e-3)
        with monitoring.span("raster.setup"):
            clock.advance(1.0)
    assert len(made) == 4
    assert monitoring.summary()["spans"]["raster.setup"]["device_s"] == pytest.approx(3e-3)


def _known_spans(clock):
    """Two fitter steps (4 ms, a 1 ms raster set-up inside) and one 5 ms
    read-back; two train steps (10 ms) each after a 3 ms data.batch; two
    predictions (6 ms) each with a 2 ms SMIL forward after it."""
    span = monitoring.span
    with monitoring.recording():
        with span("fit.stage"):
            for _ in range(2):
                with span("fit.step"):
                    clock.advance(1.5)
                    with span("raster.setup"):
                        clock.advance(1.0)
                    clock.advance(1.5)
            with span("fit.readback"):
                clock.advance(5.0)
        for _ in range(2):
            with span("data.batch"):
                clock.advance(3.0)
            with span("train.step"):
                clock.advance(10.0)
        for _ in range(2):
            with span("infer.predict"):
                clock.advance(6.0)
            with span("infer.smil_forward"):
                clock.advance(2.0)


READINGS = {"fit.step_host_ms": 4.0, "fit.readback_wait_ms_per_step": 2.5,
            "fit.raster_setup_ms_per_step": 1.0, "train.step_host_ms": 10.0,
            "train.batch_wait_ms_per_step": 3.0, "infer.predict_host_ms": 8.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_span_readers_give_the_ms_of_known_spans(metric, monkeypatch):
    reader = harness.load_file(harness.HERE / "metrics" / f"{metric}.py")
    obs = {"chips": 1, "trace": {}}
    assert reader.read(obs) is None                      # nothing recorded
    clock = _Clock()
    monkeypatch.setattr(monitoring, "time", types.SimpleNamespace(
        perf_counter_ns=clock.perf_counter_ns))
    monkeypatch.setattr(monitoring.MONITOR, "_event_pair", clock.event_pair)
    _known_spans(clock)
    assert reader.read({"chips": 1}) is None             # no trace
    assert reader.read(obs) == pytest.approx(READINGS[metric], rel=1e-12)
