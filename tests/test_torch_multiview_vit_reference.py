"""SMILify's default multi-view regressor (a ViT backbone over several
views, cross-view fusion, the camera heads in delta mode, the IEF decoder,
the multi-view loss with its DLT term, AdamW with the global-norm clip)
held to the benchmark's plain PyTorch reference
(``portbench/reference/multiview.py``) on the CPU, in float32, on seeded
random weights at a small size: a 2-block ViT of width 64 at 64² (4 × 4
patch tokens a view), 3 view slots of 18 canonical cameras with one view
of the second frame masked, a decoder of width 32, 2 layers, 2 iterations.

The port is built as its trainer builds it (``TrainingConfig`` →
``regressor_config`` → ``MultiViewSMILRegressor``, ``multiview_setup``'s
apply and loss functions, ``build_optimizer``, ``make_train_step``,
``DeviceDataCache``); the ViT's widths are registered under a test name,
since the port builds its backbones by name. Also: the spans and counters
of a multi-view train step, the benchmark's three multi-view span readers
and its ViT FLOP count."""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import types

import numpy as np
import pytest
import torch

from portbench import harness, inputs, inputs_mv, program, work_mv
from portbench.reference import multiview as ref_mv
from portbench.reference import regressor as ref_reg
from portbench.reference import smil
from smilify_tpu_torch.models import backbones
from smilify_tpu_torch.models.multiview import (
    MULTIVIEW_DEFAULT_LOSS_WEIGHTS,
    MultiViewSMILRegressor,
)
from smilify_tpu_torch.train import multiview_setup, trainer
from smilify_tpu_torch.train.config import config_from_dict
from smilify_tpu_torch.utils import monitoring

VIT = "vit_test_2x64"
RES, V, SEED = 64, 3, (1 << 31) + 20
LOSS_WEIGHTS = {"global_rot": 0.0, "joint_rot": 0.001, "betas": 0.0005, "trans": 0.0005,
                "fov": 0.001, "cam_rot": 0.01, "cam_trans": 0.01, "keypoint_2d": 0.1,
                "keypoint_3d": 0.25, "triangulation_consistency": 0.1,
                "joint_angle_regularization": 0.001}
CFG = {
    "vit": {"depth": 2, "dim": 64, "heads": 4, "mlp": 256, "patch": 16},
    "head": {"dim": 32, "depth": 2, "heads": 2, "mlp": 48, "iters": 2},
    "fusion": {"heads": 2, "layers": 2},
    "camera_hidden": 256, "views": V, "canonical_cameras": 18, "image_size": RES,
    "model": {"kind": "smil_procedural", "V_side": 8, "J": 6, "B": 3},
    "cache_samples": 4, "loss_weights": LOSS_WEIGHTS,
}
TRAFFIC = {"views_present": [[3, 1.0]], "visible": 0.8, "fov_deg": [30.0, 60.0],
           "distance": [2.0, 3.0], "elevation_rad": [-0.3, 0.8]}
TRAINING = {
    "mode": "multi_view",
    "model": {"backbone_name": VIT, "head_type": "transformer_decoder", "transformer_depth": 2,
              "transformer_heads": 2, "transformer_dim_head": 16, "transformer_mlp_dim": 48,
              "transformer_ief_iters": 2, "freeze_backbone": False, "backbone_lr_multiplier": 0.1},
    "multiview": {"num_views_to_use": V, "num_canonical_cameras": 18, "cross_attention_heads": 2,
                  "cross_attention_layers": 2},
    # a clip far below the gradient's norm, so that it acts in every step
    "optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01,
                  "gradient_clip_norm": 1e-3},
    "training": {"batch_size": 2, "use_gt_camera_init": True, "use_mixed_precision": False},
    "scale_trans_beta": {"mode": "ignore"},
}
OPT = {"lr": 1e-3, "weight_decay": 0.01, "clip": 1e-3, "backbone_lr_multiplier": 0.1}


@pytest.fixture(autouse=True)
def tiny_vit(monkeypatch):
    monkeypatch.setitem(backbones.BACKBONES, VIT, lambda img_size=224: (
        backbones.ViT(2, 64, 4, img_size=img_size), 64))
    monitoring.reset()
    yield
    monitoring.reset()


def _mask(frames, frame, slot):
    """The view ``slot`` of ``frame`` masked, as the data path leaves a
    missing view: a zero image, no visible keypoint, the slot's camera kept."""
    c = frames.cols
    c["view_mask"][frame, slot] = False
    c["images"][frame, slot] = 0
    c["keypoint_visibility"][frame, slot] = 0.0
    c["keypoints_2d"][frame, slot] = 0.0


def build(visible=1.0):
    """(inputs, the port's model, apply_fn, loss_fn, cache, TrainingConfig)
    with the second frame's last view masked and each joint of a present
    view visible with probability ``visible``."""
    torch.manual_seed(0)
    mesh_np = inputs.mesh(CFG["model"], SEED)
    m = smil.to_torch(mesh_np, "cpu")
    frames = inputs_mv.Frames(CFG, dict(TRAFFIC, visible=visible), m, SEED, "cpu")
    _mask(frames, 1, V - 1)
    inp = {"mesh_np": mesh_np, "m": m, "frames": frames,
           "weights": inputs_mv.weights(CFG, SEED, "cpu")}
    tc = config_from_dict(TRAINING).validate()
    spec = program.spec(mesh_np, "cpu")
    rcfg = tc.regressor_config(spec)
    model = MultiViewSMILRegressor(rcfg, img_size=RES)
    model.load_state_dict(inp["weights"], strict=True)
    model.train()
    apply_fn = multiview_setup.make_multiview_apply_fn(rcfg, spec, (RES, RES))
    loss_fn = multiview_setup.make_multiview_loss_fn(spec, rcfg, tc.get_loss_weights_for_epoch(0),
                                                     (RES, RES))
    return inp, model, apply_fn, loss_fn, trainer.DeviceDataCache(frames, "cpu"), tc


@pytest.fixture
def setup():
    return build()


def _ref_loss(inp, w, idx):
    batch = inp["frames"].batch(idx, "cpu")
    J, B = CFG["model"]["J"], CFG["model"]["B"]
    return ref_mv.loss(inp["m"], ref_mv.forward(w, batch, CFG, J, B), batch, LOSS_WEIGHTS, RES)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def test_epoch0_loss_weights_are_the_published_ones_the_reference_takes(setup):
    tc = setup[5]
    merged = dict(MULTIVIEW_DEFAULT_LOSS_WEIGHTS, **tc.get_loss_weights_for_epoch(0))
    assert {k: merged[k] for k in LOSS_WEIGHTS} == LOSS_WEIGHTS


def test_forward_matches_the_reference(setup):
    """Decoded predictions, float32. The ViT's attention (the port's SDPA
    against an explicit softmax), its fused GEMMs and the decoder's sums
    run in other orders: float32 round-off grown through two blocks, two
    IEF iterations and the 6D → axis-angle decode stays under 1e-5 of each
    group's norm (observed 2.9e-7)."""
    inp, model, apply_fn, _, cache, _ = setup
    idx = np.array([0, 1])
    with torch.no_grad():
        preds = apply_fn(model, cache.batch(idx), True)
        ref = ref_mv.forward(inp["weights"], inp["frames"].batch(idx, "cpu"), CFG,
                             CFG["model"]["J"], CFG["model"]["B"])
    for k in ("global_rot", "joint_rot", "betas", "trans", "view_fov", "view_cam_rot",
              "view_cam_trans"):
        assert torch.isfinite(preds[k]).all(), k
        assert _rel(preds[k], ref[k]) < 1e-5, k


# each joint's rank-2 rows of a view it is visible in: with every joint seen
# in two views or more the DLT's damped normal equations are well
# conditioned; at the cell's visibility (0.8) some joint is seen in one view
# only, and its system is rank 2 plus λ = 1e-4, a condition of ~|P|²/λ ≈
# 1e4-1e5. The two packages' solves of the same matrices agree bit for bit,
# but the predicted cameras' 1e-7 round-off moves such a joint's point by up
# to ~4e-4 (its float32 solve is that far from float64's), and that grows
# into the DLT term and, through its backward, into the cameras', the
# fusion's and the ViT's gradients
DLT_TOL = {1.0: {"dlt": 1e-5, "total": 1e-5, "grad": 1e-5},     # observed 8e-8 / 8e-8 / 1.2e-6
           0.8: {"dlt": 5e-3, "total": 1e-3, "grad": 2e-2}}     # observed 6.4e-4 / 2.3e-4 / 3.2e-3


@pytest.mark.parametrize("visible", sorted(DLT_TOL))
def test_loss_with_the_dlt_term_matches_the_reference(visible):
    """The multi-view loss and its DLT component, float32 (tolerances:
    ``DLT_TOL``); the other terms within the forward's 1e-5."""
    inp, model, apply_fn, loss_fn, cache, _ = build(visible)
    tol = DLT_TOL[visible]
    idx = np.array([0, 1])
    with torch.no_grad():
        total, objs = loss_fn(apply_fn(model, cache.batch(idx), True), cache.batch(idx))
        ref = _ref_loss(inp, inp["weights"], idx)
        batch = inp["frames"].batch(idx, "cpu")
        preds = ref_mv.forward(inp["weights"], batch, CFG, CFG["model"]["J"], CFG["model"]["B"])
        _, joints = ref_reg.pose(inp["m"], preds)
        kp = batch["keypoints_2d"].flip(-1) / RES
        ndc = torch.stack([(RES - 1.0 - 2.0 * kp[..., 1] * RES) / RES,
                           (RES - 1.0 - 2.0 * kp[..., 0] * RES) / RES], -1)
        vm = batch["view_mask"].float()
        tri = ref_mv.triangulate(ndc, ref_mv.clip_matrices(preds),
                                 vm[..., None] * batch["keypoint_visibility"])
        dlt = LOSS_WEIGHTS["triangulation_consistency"] * ((tri - joints) ** 2).mean()
    assert float(objs["triangulation_consistency"]) > 0
    assert abs(float(objs["triangulation_consistency"]) / float(dlt) - 1) < tol["dlt"]
    assert abs(float(total) / float(ref) - 1) < tol["total"]
    rest = float(total - objs["triangulation_consistency"])
    assert abs(rest / (float(ref) - float(dlt)) - 1) < 1e-5


def _port_grads(model, apply_fn, loss_fn, batch):
    model.zero_grad()
    total, _ = loss_fn(apply_fn(model, batch, True), batch)
    total.backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _ref_grads(inp, idx):
    w = {k: v.detach().clone().requires_grad_(True) for k, v in inp["weights"].items()}
    total = _ref_loss(inp, w, idx)
    names = list(w)
    return dict(zip(names, torch.autograd.grad(total, [w[k] for k in names])))


def _grad_gaps(port, ref):
    """Each leaf's gradient gap against its own norm or the median leaf's,
    whichever is larger (a leaf whose gradient cancels to its round-off
    is held to the median's scale, as the benchmark's training rule holds it)."""
    med = float(np.median([float(torch.linalg.vector_norm(g)) for g in ref.values()]))
    return {k: float(torch.linalg.vector_norm(port[k] - g))
            / max(float(torch.linalg.vector_norm(g)), med) for k, g in ref.items()}


@pytest.mark.parametrize("visible", sorted(DLT_TOL))
def test_every_parameter_gradient_matches_the_reference(visible):
    """Every parameter's gradient, float32, against the larger of its norm
    and the median leaf's (tolerances: ``DLT_TOL``)."""
    inp, model, apply_fn, loss_fn, cache, _ = build(visible)
    idx = np.array([0, 1])
    port = _port_grads(model, apply_fn, loss_fn, cache.batch(idx))
    ref = _ref_grads(inp, idx)
    assert set(port) == set(ref)
    assert all(torch.isfinite(g).all() for g in port.values())
    gaps = _grad_gaps(port, ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < DLT_TOL[visible]["grad"], (worst, gaps[worst])
    # every group of the model receives a gradient
    for prefix in ("backbone.", "view_embeddings.", "cross_view_fusion.", "body_head.",
                   "camera_head."):
        assert any(float(g.abs().max()) > 0 for k, g in port.items() if k.startswith(prefix))


def test_adamw_steps_with_the_clip_and_the_backbone_group_match_the_reference(setup):
    """Two steps of ``build_optimizer``'s AdamW through ``make_train_step``
    (the clip acting on both: their gradients' norms differ, so the second
    update mixes two clip factors; the backbone's group at 0.1 of the lr)
    against the reference's AdamW: each parameter's change within 1e-4 of
    the larger of its norm and the median leaf's. Adam's first update is
    ~lr·sign(g) where |g| ≫ ε, so a gradient's round-off moves it most
    where an element's gradient is near ε's scale (observed 1.9e-5; the
    second step's loss 5e-7 apart, within the forward's 1e-5)."""
    inp, model, apply_fn, loss_fn, cache, tc = setup
    opt = trainer.build_optimizer(tc, tc.get_learning_rate_for_epoch(0), backbone_frozen=False,
                                  model=model)
    assert [g["lr"] for g in opt.inner.param_groups] == [pytest.approx(1e-3), pytest.approx(1e-4)]
    assert {opt.labels[k] for k in opt.labels if k.startswith("backbone.")} == {"backbone"}
    assert {opt.labels[k] for k in opt.labels if not k.startswith("backbone.")} == {"head"}
    step = trainer.make_train_step(model, apply_fn, loss_fn, opt)
    order = [np.array([0, 1]), np.array([2, 3])]
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    for idx in order:
        loss, _ = step(cache.batch(idx))
        assert float(opt.grad_norm) > TRAINING["optimizer"]["gradient_clip_norm"]
    J, B = CFG["model"]["J"], CFG["model"]["B"]
    losses, first, after = ref_mv.train_steps(
        inp["weights"], inp["m"], [inp["frames"].batch(i, "cpu") for i in order], CFG, J, B,
        LOSS_WEIGHTS, OPT)
    assert abs(float(loss) / losses[1] - 1) < 1e-5
    port = {k: v.detach() - start[k] for k, v in model.named_parameters()}
    ref = {k: after[k] - inp["weights"][k] for k in port}
    gaps = _grad_gaps(port, ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 1e-4, (worst, gaps[worst])
    # the backbone moved at a tenth of the head's rate (both ~lr·√n after Adam)
    per = {k: float(torch.linalg.vector_norm(d)) / d.numel() ** 0.5 for k, d in port.items()
           if d.numel() > 16}
    bb = np.median([v for k, v in per.items() if k.startswith("backbone.")])
    hd = np.median([v for k, v in per.items() if k.startswith("body_head.")])
    assert 0.05 < bb / hd < 0.2


def test_frames_with_two_views_stay_finite_and_agree(setup):
    """Frames with two of three views present (every joint visible in
    both): the fusion's masked attention, the masked means and the DLT
    with one view's rows zeroed stay finite, and the loss and gradients
    agree with the reference at the well-conditioned tolerances."""
    inp, model, apply_fn, loss_fn, _, _ = setup
    for f in (0, 1, 2, 3):
        _mask(inp["frames"], f, V - 1)
    cache = trainer.DeviceDataCache(inp["frames"], "cpu")
    idx = np.array([2, 3])
    batch = cache.batch(idx)
    assert batch["view_mask"].sum(1).tolist() == [2, 2]
    with torch.no_grad():
        total, _ = loss_fn(apply_fn(model, batch, True), batch)
    assert torch.isfinite(total)
    assert abs(float(total) / float(_ref_loss(inp, inp["weights"], idx)) - 1) < 1e-5
    port = _port_grads(model, apply_fn, loss_fn, batch)
    assert all(torch.isfinite(g).all() for g in port.values())
    gaps = _grad_gaps(port, _ref_grads(inp, idx))
    assert max(gaps.values()) < DLT_TOL[1.0]["grad"]


MV_SPANS = ("model.backbone", "model.fusion", "model.head", "model.camera_head", "model.decode",
            "train.triangulate")


@pytest.mark.parametrize("chunk,images,chunks", [(None, 2 * V, 1), (4, 8, 2)])
def test_train_step_records_the_multiview_spans_and_counters(setup, chunk, images, chunks):
    """One train step under ``recording()``: each new span once, in its
    parent, and ``model.backbone.images`` = the images through the
    backbone (B·V, or the padded chunks' with ``backbone_chunk_size``)."""
    import dataclasses

    inp, model, _, _, cache, tc = setup
    spec = program.spec(inp["mesh_np"], "cpu")
    rcfg = dataclasses.replace(model.config, backbone_chunk_size=chunk)
    model.config = rcfg
    step = trainer.make_train_step(
        model, multiview_setup.make_multiview_apply_fn(rcfg, spec, (RES, RES)),
        multiview_setup.make_multiview_loss_fn(spec, rcfg, tc.get_loss_weights_for_epoch(0),
                                               (RES, RES)),
        trainer.build_optimizer(tc, 1e-3, backbone_frozen=False, model=model))
    with monitoring.recording():
        loss, _ = step(cache.batch(np.array([0, 1])))
    assert torch.isfinite(loss)
    s = monitoring.summary()
    assert {k: s["spans"][k]["count"] for k in MV_SPANS} == dict.fromkeys(MV_SPANS, 1)
    assert s["counters"]["model.backbone.images"] == images
    assert s["counters"]["model.backbone.chunks"] == chunks
    names = {rec.index: rec.name for rec in monitoring.MONITOR.log}
    parents = {rec.name: names.get(rec.parent) for rec in monitoring.MONITOR.log}
    assert {k: parents[k] for k in MV_SPANS} == {
        "model.backbone": "train.step", "model.fusion": "train.step", "model.head": "train.step",
        "model.camera_head": "train.step", "model.decode": "train.step",
        "train.triangulate": "train.loss"}


class _Event:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def record(self, stream):
        self.t = self.clock.ns

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


class _Clock:
    """A host clock that moves only when told, and CUDA-like events on it."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def advance(self, ms):
        self.ns += int(ms * 1e6)

    def event_pair(self):
        return None, _Event(self), _Event(self)


READINGS = {"mvtrain.backbone_ms_per_step": 30.0, "mvtrain.head_ms_per_step": 7.5,
            "mvtrain.triangulate_ms_per_step": 0.5}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_multiview_span_readers_give_device_ms_of_known_spans(metric, monkeypatch):
    """Two train steps, each with a 30 ms backbone, a 7.5 ms head and a
    0.5 ms DLT term, on event pairs of a clock moved by hand."""
    reader = harness.load_file(harness.HERE / "metrics" / f"{metric}.py")
    obs = {"chips": 1, "trace": {}}
    assert reader.read(obs) is None                      # nothing recorded
    clock = _Clock()
    monkeypatch.setattr(monitoring, "time", types.SimpleNamespace(
        perf_counter_ns=clock.perf_counter_ns))
    with monitoring.recording():
        with monitoring.span("train.step"):              # off the card: no device time
            clock.advance(1.0)
    assert reader.read(obs) is None
    monitoring.reset()
    monkeypatch.setattr(monitoring.MONITOR, "_event_pair", clock.event_pair)
    with monitoring.recording():
        for _ in range(2):
            with monitoring.span("train.step"):
                with monitoring.span("model.backbone"):
                    clock.advance(30.0)
                with monitoring.span("model.head"):
                    clock.advance(7.5)
                with monitoring.span("train.loss"):
                    with monitoring.span("train.triangulate"):
                        clock.advance(0.5)
    assert reader.read({"chips": 1}) is None             # no trace
    assert reader.read(obs) == pytest.approx(READINGS[metric], rel=1e-12)


def test_vit_flops_match_the_published_count():
    """ViT-L/16 at 224²: 61.6 G multiply-adds a forward (Dosovitskiy et al.
    2021, Table 6), so 123.2 GFLOP; ViT-B/16: 17.6 G, 35.2 GFLOP."""
    assert work_mv.vit_flops(224, 24, 1024, 4096, 16) / 123.2e9 == pytest.approx(1.0, abs=0.01)
    assert work_mv.vit_flops(224, 12, 768, 3072, 16) / 35.2e9 == pytest.approx(1.0, abs=0.01)
