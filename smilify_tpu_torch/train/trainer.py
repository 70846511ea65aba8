"""Training loop for the neural regressors (port of
``smilify_tpu/train/trainer.py``), on one device.

* :func:`build_optimizer`: optax's chain as the JAX package builds it —
  ``apply_if_finite(chain(clip_by_global_norm, multi_transform({head,
  backbone, backbone_frozen})), 16)`` — on the model's parameters in place,
  with the groups labelled from the Flax paths of the parameters;
* :func:`make_train_step` (gradient accumulation over micro-batches, the
  BatchNorm statistics advancing once a micro-batch) and
  :func:`make_eval_step`;
* the epoch runner: :func:`iterate_batches` (serial, thread or cached
  process pools), :func:`end_of_epoch_outputs`, :func:`plot_training_history`
  and :func:`try_resume`;
* :class:`TrainState` and the checkpoints (``<name>.pt`` holding the model's
  state dict and the optimizer's state beside the JAX package's
  ``<name>.meta.json``: epoch, step, the full config and the history), the
  pinned-memory :class:`StagingCollator`, the seeded dataset splits,
  :class:`SubsetDataset` and :class:`DeviceDataCache`.

A step reads nothing back to the host: the non-finite test, the clip and
the skip are device tensors updated in place, the skip through the fused
Adam kernel's ``found_inf`` flag. So on one card the whole step replays as
a CUDA graph (:func:`make_train_step`).

Data-parallel training over a ``('data',)`` mesh (:func:`data_mesh`, one
rank a process): the model runs inside ``DistributedDataParallel`` over the
mesh's group, its BatchNorms normalize with the global batch's statistics
(``models/backbones.py::sync_batchnorm``, as XLA computes them over a
sharded batch), each rank takes its rows of every global batch
(:func:`shard_batch`; the device cache takes them itself), ``accum_steps``
micro-batches run under ``no_sync`` but the last, and the reported and
validation losses are averaged over the ranks. The epoch loop decides
collectively whether a batch is skipped and when the epoch ends, so no rank
enters a collective that another left (:func:`train_epochs`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.utils import monitoring
from smilify_tpu_torch.utils.graphs import Replayer

# numpy dtype → the 32-bit one JAX's default mode stores (the JAX cache's columns)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


class DeviceDataCache:
    """An entire (small) dataset resident in device memory; each batch is a
    gather on the device driven by a small host index array.

    Columns are every numeric field of the samples, stacked. Images (the
    ``image_keys``) are stored as uint8 (lossless for JPEG-decoded data, a
    quarter of float32's bytes: 1,600 samples of 4 views at 96² are 177 MB)
    and converted to float in :meth:`batch`, so a step moves only a
    batch-size index array from the host. 64-bit columns are stored in 32
    bits, as the JAX package's cache stores them.

    Under data parallelism each rank holds the whole cache and takes its
    rows of every global batch (``rows``, from :func:`rank_rows`), so the
    global batches are the single-device run's. On-the-fly augmentation
    needs the host pipeline.
    """

    def __init__(self, dataset, device="cuda", image_keys=("image", "images")):
        self.device = resolve_device(device)
        first = dataset[0]
        keys = [k for k, v in first.items()
                if isinstance(v, (np.ndarray, int, float, np.generic))
                and np.asarray(v).dtype.kind in "fiub"]
        stacked = {k: [] for k in keys}
        for i in range(len(dataset)):
            s = dataset[i]
            for k in keys:
                stacked[k].append(np.asarray(s[k]))
        cols = {}
        for k in keys:
            arr = np.stack(stacked[k])
            if k in image_keys and arr.dtype == np.float32:
                arr = np.round(arr * 255.0).astype(np.uint8)
            cols[k] = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
        self.n = len(dataset)
        self._image_keys = tuple(k for k in image_keys if k in cols)
        self.arrays = {k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}
        self.bytes = sum(t.numel() * t.element_size() for t in self.arrays.values())

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """The samples ``idx`` as a dict of device tensors, images as float in [0, 1]."""
        with monitoring.span("data.batch"):
            i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
            b = {k: torch.index_select(v, 0, i) for k, v in self.arrays.items()}
            for k in self._image_keys:
                if b[k].dtype == torch.uint8:
                    # times the float32 reciprocal, as XLA compiles the JAX cache's
                    # division (true division rounds 126 of the 256 levels apart)
                    b[k] = b[k].to(torch.float32) * (1.0 / 255.0)
            return b

    def iterate(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, fraction: float = 1.0, rows=None):
        """Full batches over the cache (drop_last): the index sequence of the
        JAX cache for the same ``rng``; ``rows`` picks this rank's positions
        in each batch."""
        idx = rng.permutation(self.n) if shuffle else np.arange(self.n)
        if fraction < 1.0:
            idx = idx[: max(1, int(self.n * fraction))]
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            b = idx[i: i + batch_size]
            yield self.batch(b if rows is None else b[rows])


# ---------------------------------------------------------------------------
# the data-parallel mesh
# ---------------------------------------------------------------------------


def data_mesh(device="cuda"):
    """A 1-axis ``('data',)`` mesh over every rank of the process group,
    or None in a single process (one device: no data parallelism)."""
    from smilify_tpu_torch.train.multihost import make_mesh, process_count

    n = process_count()
    return make_mesh((n,), ("data",), device) if n > 1 else None


def rank_rows(batch_size: int, mesh, accum_steps: int = 1) -> np.ndarray:
    """This rank's positions in a global batch of ``batch_size``: its
    share of each of the ``accum_steps`` micro-batches, so the global
    micro-batches are the single-device step's (micro-batch i holds rows
    [i·m, (i+1)·m) of the batch, m = batch_size / accum_steps)."""
    from smilify_tpu_torch.train.multihost import axis_group

    _, n, r = axis_group(mesh, "data")
    if batch_size % (n * accum_steps):
        raise ValueError(f"batch {batch_size} not divisible by {n} ranks × "
                         f"{accum_steps} micro-batches")
    m = batch_size // accum_steps
    k = m // n
    return (np.arange(accum_steps)[:, None] * m + r * k + np.arange(k)[None]).reshape(-1)


def shard_batch(mesh, batch: Dict[str, Any], accum_steps: int = 1) -> Dict[str, Any]:
    """This rank's rows (:func:`rank_rows`) of a global batch given whole on
    every rank; the batch itself without a mesh."""
    if mesh is None:
        return batch
    n = len(next(iter(batch.values())))
    rows = rank_rows(n, mesh, accum_steps)
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        else:
            out[k] = np.asarray(v)[rows]
    return out


def data_parallel(model: torch.nn.Module, mesh):
    """``(net, group)``: ``model`` inside ``DistributedDataParallel`` over the
    mesh's ``data`` group (a group of one rank included) with its
    BatchNorms on the global batch, or the model itself (and None) without a
    mesh. The wrapper is made once a model and kept on it: a second wrapper
    would reduce every gradient twice."""
    from smilify_tpu_torch.models.backbones import sync_batchnorm
    from smilify_tpu_torch.train.multihost import axis_group

    if mesh is None:
        return model, None
    group, _, _ = axis_group(mesh, "data")
    ddp = model.__dict__.get("_data_parallel")
    if ddp is None or ddp.process_group is not group:
        sync_batchnorm(model, group)
        # the running statistics are the same on every rank by construction
        # (global-batch statistics): no buffer broadcast a step
        with warnings.catch_warnings():
            # newer releases rename broadcast_buffers; the card's still takes it
            warnings.simplefilter("ignore", FutureWarning)
            ddp = torch.nn.parallel.DistributedDataParallel(
                model, process_group=group, broadcast_buffers=False)
        model.__dict__["_data_parallel"] = ddp
    return ddp, group


def _mean_over(group, *tensors):
    """The tensors averaged over ``group`` (one all-reduce of them stacked);
    as they are without a group."""
    if group is None:
        return tensors
    from smilify_tpu_torch.train.multihost import all_reduce_sum

    flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
    all_reduce_sum(flat, group)
    flat /= torch.distributed.get_world_size(group)
    return tuple(flat.unbind(0))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

MAX_CONSECUTIVE_ERRORS = 16     # optax.apply_if_finite's, as the JAX package sets it
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8     # optax's defaults


def is_backbone_path(path: str) -> bool:
    """The JAX package's label: a parameter belongs to the backbone group
    when its Flax path names a ResNet, ViT or UNet module or a backbone."""
    return "ResNet" in path or "ViT" in path or "UNet" in path or "backbone" in path.lower()


class Optimizer:
    """The JAX package's ``build_optimizer`` transformation, applied to a
    model's parameters in place by :meth:`step` after a backward pass.

    * every gradient, the frozen backbone's included, is clipped by the
      global norm with optax's formula ``g / ‖g‖ · max_norm`` where ‖g‖ ≥
      max_norm (no epsilon, unlike ``clip_grad_norm_``);
    * Adam or AdamW (``torch.optim``'s fused kernel) on a head group at
      ``lr`` and a backbone group at ``lr × backbone_lr_multiplier``; a
      frozen backbone gets no update and no Adam state;
    * ``apply_if_finite(16)``: a step whose raw gradients hold a NaN or an
      infinity updates nothing, Adam's moments and step count included,
      unless it is the 17th or later such step in a row, which is applied.

    The test and the skip stay on the device: the fused kernel skips a step
    whose ``found_inf`` flag is 1, so a step reads nothing back to the host.
    Adam is built ``capturable`` and ``notfinite_count``, ``total_notfinite``,
    ``grad_norm`` and the ``found_inf`` flag are tensors made once and
    updated in place, so a replayed CUDA graph of the step advances them.
    """

    def __init__(self, model: torch.nn.Module, cfg, lr: float, backbone_frozen: bool):
        from smilify_tpu_torch.models.weight_port import flax_module_paths

        paths = flax_module_paths(model)
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.labels: Dict[str, str] = {}
        groups = {"head": [], "backbone": [], "backbone_frozen": []}
        for name, p in named:
            label = "head"
            if is_backbone_path(paths.get(name, name)):
                label = "backbone_frozen" if backbone_frozen else "backbone"
            self.labels[name] = label
            groups[label].append(p)
        kind = cfg.optimizer.optimizer_type.lower()
        if kind == "adam":
            make, kw = torch.optim.Adam, {}
        elif kind == "adamw":
            make, kw = torch.optim.AdamW, {"weight_decay": cfg.optimizer.weight_decay}
        else:
            raise ValueError(f"unknown optimizer_type '{cfg.optimizer.optimizer_type}'")
        param_groups = [{"params": ps, "lr": r} for ps, r in (
            (groups["head"], lr), (groups["backbone"], lr * cfg.model.backbone_lr_multiplier)) if ps]
        self.inner = (make(param_groups, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, fused=True,
                           capturable=True, **kw)
                      if param_groups else None)
        self.max_norm = float(cfg.optimizer.gradient_clip_norm)
        dev = self.params[0].device
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.grad_norm = torch.zeros((), device=dev)
        if self.inner is not None:
            self.inner.found_inf = torch.zeros((), device=dev)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:          # a parameter the loss does not reach: a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        # every element finite ⇔ every max |g| finite (a NaN or ±inf propagates)
        finite = torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.max_norm
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        # under DistributedDataParallel the gradients read here are already
        # the all-reduced ones, the same on every rank: every rank takes the
        # same decision and the replicas stay equal
        self.notfinite_count.copy_(torch.where(finite, torch.zeros_like(self.notfinite_count),
                                               self.notfinite_count + 1))
        self.total_notfinite.add_((~finite).to(torch.int32))
        apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        self.grad_norm.copy_(g_norm)
        if self.inner is not None:
            self.inner.found_inf.copy_(~apply)
            self.inner.step()

    def adam_step(self) -> torch.Tensor:
        """Adam's step count (the optax ``count``) of the first updated parameter."""
        for group in self.inner.param_groups:
            for p in group["params"]:
                if p in self.inner.state:
                    return self.inner.state[p]["step"]
        return torch.zeros(())

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint keeps (the trainers start each optimizer anew,
        as the JAX ones call ``tx.init``, so nothing reads it back yet)."""
        return {"inner": None if self.inner is None else self.inner.state_dict(),
                "notfinite_count": self.notfinite_count, "total_notfinite": self.total_notfinite}


class PlainAdam:
    """``optax.adam(lr)`` (or ``optax.adamw(lr, weight_decay)``) alone, no
    clip and no skip: the JAX benches' and PointNet trainer's optimizer, in
    the interface :func:`make_train_step` takes (``params``, ``step()``)."""

    def __init__(self, model: torch.nn.Module, lr: float, weight_decay: Optional[float] = None):
        self.params = list(model.parameters())
        make, kw = (torch.optim.Adam, {}) if weight_decay is None else (
            torch.optim.AdamW, {"weight_decay": weight_decay})
        self.inner = make(self.params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, fused=True,
                          capturable=True, **kw)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.inner.step()


def build_optimizer(cfg, lr: float, backbone_frozen: bool, model: torch.nn.Module) -> Optimizer:
    """Adam/AdamW (``optimizer.optimizer_type``) with the global-norm clip
    and the non-finite skip, the backbone a separate (possibly frozen) group;
    fresh moments, as the JAX trainers' ``tx.init`` gives."""
    return Optimizer(model, cfg, lr, backbone_frozen)


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def _split_batch(batch, n: int) -> List:
    """``batch`` (tensors, possibly in nested dicts) cut into ``n``
    micro-batches along the leading axis."""
    if isinstance(batch, dict):
        parts = {k: _split_batch(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(batch, torch.Tensor):
        return list(batch.reshape((n, -1) + tuple(batch.shape[1:])).unbind(0))
    return [batch] * n


def make_train_step(model: torch.nn.Module, apply_fn: Callable, loss_fn: Callable,
                    opt: Optimizer, accum_steps: int = 1, mesh=None):
    """``step(batch) -> (loss, components)``, both device tensors of the
    call's own.

    ``apply_fn(model, batch, train) -> preds`` (the model in train mode
    advances its BatchNorm statistics in place); ``loss_fn(preds, batch) ->
    (total, components)``. With ``accum_steps > 1`` the batch is cut into
    that many micro-batches: the gradients are averaged over them, the
    statistics advance once a micro-batch, and the loss and each component
    are the micro-batches' means. The statistics advance on a skipped
    (non-finite) step too, as the JAX step returns its new statistics
    unconditionally.

    On one card the whole step (forward, loss, backward, the statistics and
    the optimizer) replays as a CUDA graph once a batch's ``graph_key``
    has been seen twice (``utils/graphs.py``'s
    :class:`~smilify_tpu_torch.utils.graphs.Replayer`): the key's first call
    runs eagerly, its second eagerly under torch's sync debug mode, and
    unless that call waited on the host (a read-back, a blocking copy), the
    third captures the graph; the gradients are assigned inside the
    graph's memory. The same kernels run on the same numbers either way.
    The spans inside the step (``model.*``, ``train.loss``,
    ``train.backward``, ``train.update``) record on eager and capturing
    calls only. Counted while recording: ``train.graph.eager``,
    ``train.graph.captures``, ``train.graph.replays``. A step built anew
    brings its own graphs, freed with it.

    With a ``('data',)`` ``mesh`` of several ranks (:func:`data_mesh`) the
    batch is this rank's rows of the global batch (:func:`shard_batch`);
    the model runs inside ``DistributedDataParallel``
    (:func:`data_parallel`), the gradients are all-reduced once a step (the
    micro-batches but the last run under ``no_sync``), and the loss and its
    components are averaged over the ranks. Such a step runs eagerly."""
    net, group = data_parallel(model, mesh)

    def compute(mb):
        preds = apply_fn(net, mb, True)
        with monitoring.span("train.loss"):
            total, objs = loss_fn(preds, mb)
        with monitoring.span("train.backward"):
            total.backward()
        return total.detach(), {k: v.detach() for k, v in objs.items()}

    def work(batch):
        # gradients assigned anew by the backward (inside a capture: in the graph's memory)
        for p in opt.params:
            p.grad = None
        if accum_steps > 1:
            mbs = _split_batch(batch, accum_steps)
            outs = []
            for i, mb in enumerate(mbs):
                quiet = group is not None and i < len(mbs) - 1
                with net.no_sync() if quiet else contextlib.nullcontext():
                    outs.append(compute(mb))
            torch._foreach_div_([p.grad for p in opt.params if p.grad is not None],
                                float(accum_steps))
            loss = sum(loss for loss, _ in outs) / accum_steps
            objs = {k: torch.stack([o[k] for _, o in outs]).mean() for k in outs[0][1]}
        else:
            loss, objs = compute(batch)
        with monitoring.span("train.update"):
            opt.step()
        if group is not None:
            names = list(objs)
            loss, *vals = _mean_over(group, loss, *(objs[k] for k in names))
            objs = dict(zip(names, vals))
        return loss, objs

    replay = Replayer(work, "train.graph", check_syncs=True)

    def step(batch):
        with monitoring.span("train.step"):
            model.train()
            if group is not None or not all(isinstance(v, torch.Tensor) for v in batch.values()):
                return replay.eager(batch)
            return replay(batch)

    return step


def make_eval_step(model: torch.nn.Module, apply_fn: Callable, loss_fn: Callable, mesh=None):
    """``step(batch) -> (loss, components)`` of the model in eval mode;
    with a ``('data',)`` mesh of several ranks, averaged over them (each
    rank evaluates its rows)."""
    from smilify_tpu_torch.train.multihost import axis_group

    group, n, _ = axis_group(mesh, "data")

    @torch.no_grad()
    def step(batch):
        model.eval()
        loss, objs = loss_fn(apply_fn(model, batch, False), batch)
        if n > 1:
            names = list(objs)
            loss, *vals = _mean_over(group, loss, *(objs[k] for k in names))
            objs = dict(zip(names, vals))
        return loss, objs

    return step


def narrow_floats(batch):
    """float64 tensors of ``batch`` (nested dicts too) as float32, as JAX's
    32-bit mode stores what a dataset gives in float64."""
    if isinstance(batch, dict):
        return {k: narrow_floats(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.dtype == torch.float64:
        return batch.to(torch.float32)
    return batch


# ---------------------------------------------------------------------------
# train state and checkpoints
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """``model_state`` is the model's ``state_dict()`` (parameters and
    BatchNorm statistics); ``opt_state`` the optimizer's, once the trainers
    keep one."""

    model_state: Dict[str, torch.Tensor]
    opt_state: Any = None
    epoch: int = 0
    step: int = 0
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg, name: str = "checkpoint") -> str:
    """``<ckpt_dir>/<name>.pt`` (model and optimizer state) and
    ``<ckpt_dir>/<name>.meta.json`` (epoch, step, the full config, the last
    50 history entries), as the JAX package writes its meta file. Returns
    the checkpoint's path, ``<ckpt_dir>/<name>``, which
    ``cli.run_inference.discover_checkpoint`` and :func:`load_checkpoint` take."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    model_state = {k: v.detach().cpu() for k, v in state.model_state.items()}
    torch.save({"model": model_state, "opt_state": state.opt_state}, path + ".pt")
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": state.epoch, "step": state.step, "config": cfg.to_dict(),
                   "history": state.history[-50:]}, f, indent=2, default=str)
    return path


def load_checkpoint(path: str):
    """(payload ``{"model": state dict, "opt_state": ...}`` on the CPU, meta
    dict) of the checkpoint at ``path`` (``<dir>/<name>``, without extension)."""
    payload = torch.load(path + ".pt", map_location="cpu", weights_only=False)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return payload, meta


# ---------------------------------------------------------------------------
# pinned staging buffers
# ---------------------------------------------------------------------------


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class StagingCollator:
    """Collate into a ring of ``depth`` persistent host buffers, pinned when
    a card is present, so that :meth:`to_device` copies them with
    ``non_blocking=True``.

    A batch aliases its ring slot, and a non-blocking copy reads the slot
    after the call has returned: rewriting the slot before that copy ends
    would corrupt the batch on the device without a trace. So
    :meth:`to_device` records a CUDA event behind its copies, and collating
    into that slot again first waits for the event (the copy only, not the
    work that consumes it). Returned host batches stay valid until
    ``depth − 1`` further batches have been collated. A batch whose keys,
    shapes or dtypes differ from the first one's (a ragged last batch) is
    stacked into fresh tensors instead."""

    def __init__(self, depth: int = 4):
        self.depth = depth
        self.pin = torch.cuda.is_available()
        self._ring: List[Dict[str, torch.Tensor]] = []
        self._slot = 0
        self._events: Dict[int, torch.cuda.Event] = {}

    def __call__(self, samples) -> Dict[str, torch.Tensor]:
        cols = {k: [np.asarray(s[k]) for s in samples] for k in samples[0].keys()}
        n = len(samples)
        if not self._ring:
            self._shapes = {k: (n,) + c[0].shape for k, c in cols.items()}
            self._dtypes = {k: c[0].dtype for k, c in cols.items()}
            self._ring = [
                {k: torch.empty(self._shapes[k], dtype=_torch_dtype(self._dtypes[k]),
                                pin_memory=self.pin) for k in self._shapes}
                for _ in range(self.depth)]
        ok = set(cols) == set(self._shapes) and all(
            (n,) + c[0].shape == self._shapes[k] and c[0].dtype == self._dtypes[k]
            for k, c in cols.items())
        if not ok:
            return {k: torch.from_numpy(np.stack(c)) for k, c in cols.items()}
        event = self._events.pop(self._slot, None)
        if event is not None:
            event.synchronize()   # the copy out of this slot has ended
        bufs = self._ring[self._slot]
        self._slot = (self._slot + 1) % self.depth
        for k, c in cols.items():
            host = bufs[k].numpy()
            for j, a in enumerate(c):
                host[j] = a
        return bufs

    def to_device(self, host_batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
        """``host_batch`` on ``device``; from a ring slot onto a card the
        copies are non-blocking and guarded by an event on the slot."""
        device = torch.device(device)
        out = {k: v.to(device, non_blocking=self.pin) for k, v in host_batch.items()}
        if device.type == "cuda":
            for s, bufs in enumerate(self._ring):
                if bufs is host_batch:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(device))
                    self._events[s] = event
        return out


# ---------------------------------------------------------------------------
# dataset splits
# ---------------------------------------------------------------------------


def split_dataset(n: int, ratios: Tuple[float, float, float], seed: int):
    """Seeded train/val/test index split."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    return idx[:n_train], idx[n_train:n_train + n_val], idx[n_train + n_val:]


def split_dataset_grouped(groups: np.ndarray, ratios: Tuple[float, float, float], seed: int):
    """Sample-level split over per-item group ids (expand_all_views: all
    views of a sample stay in one split, so no view leaks across)."""
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    tr_g, va_g, te_g = split_dataset(len(uniq), ratios, seed)
    idx = np.arange(len(groups))
    return tuple(idx[np.isin(groups, list(set(uniq[g])))] for g in (tr_g, va_g, te_g))


def split_dataset_per_group(groups: np.ndarray, ratios: Tuple[float, float, float], seed: int):
    """Split within each group and concatenate: every group contributes to
    every split (the 'per_dataset' strategy for combined datasets)."""
    groups = np.asarray(groups)
    tr, va, te = [], [], []
    for g in np.unique(groups):
        idx = np.nonzero(groups == g)[0]
        t, v, e = split_dataset(len(idx), ratios, seed + int(g))
        tr.append(idx[t])
        va.append(idx[v])
        te.append(idx[e])
    return np.concatenate(tr), np.concatenate(va), np.concatenate(te)


class SubsetDataset:
    """Index-subset view of a map-style dataset; forwards ``set_epoch`` /
    ``epoch`` (the per-epoch augmentation seed) to the wrapped dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)

    @property
    def epoch(self):
        return getattr(self.dataset, "epoch", None)


# ---------------------------------------------------------------------------
# epoch runner
# ---------------------------------------------------------------------------

# process-pool worker state: the dataset is shipped once a worker through the
# pool's initializer (spawn pickles it; the datasets are numpy and pickle-safe)
_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_load(args):
    j, skip_errors, epoch = args
    ds = _WORKER_DATASET
    if epoch is not None and getattr(ds, "epoch", None) != epoch:
        # the pool outlives epochs: forward the parent's set_epoch so that
        # per-epoch augmentation stays fresh in the workers
        set_epoch = getattr(ds, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
    try:
        return ds[j]
    except Exception as e:  # noqa: BLE001 — per-sample resilience
        if not skip_errors:
            raise
        print(f"warning: sample {j} failed to load ({type(e).__name__}: {e})")
        return None


# Process pools are cached across epochs: a respawn each epoch would pay the
# workers' start-up and the dataset's pickling every epoch and drop their
# DecodedSampleCache. Each worker is its own one-process executor and sample j
# always goes to worker j % W, so every worker caches a disjoint 1/W of the
# dataset. The value keeps the dataset alive so that its id() is not reused;
# concurrent.futures joins the workers at interpreter exit.
_PROCESS_POOLS: Dict[tuple, tuple] = {}


def _get_process_pools(dataset, num_workers: int):
    key = (id(dataset), num_workers)
    entry = _PROCESS_POOLS.get(key)
    if entry is not None:
        return entry[0]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    # spawn, not fork: a fork of a process that has initialized CUDA (or
    # torch's thread pools) can deadlock
    ctx = mp.get_context("spawn")
    pools = [ProcessPoolExecutor(max_workers=1, mp_context=ctx, initializer=_pool_init,
                                 initargs=(dataset,)) for _ in range(num_workers)]
    _PROCESS_POOLS[key] = (pools, dataset)
    return pools


def iterate_batches(
    dataset,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    fraction: float = 1.0,
    collate: Callable = None,
    drop_last: bool = True,
    num_workers: int = 0,
    prefetch: int = 2,
    skip_errors: bool = False,
    worker_mode: str = "thread",
) -> Iterable[Dict[str, np.ndarray]]:
    """Host-side batcher with per-epoch fractional subsampling: the JAX
    package's index order for the same ``rng``.

    ``num_workers > 0`` loads samples through a pool with a bounded
    look-ahead of ``prefetch`` batches; ``worker_mode`` ``"thread"`` (decode
    and augmentation release the GIL in cv2/numpy) or ``"process"`` (the
    cached spawn pools, sample j on worker j % W). ``skip_errors`` drops
    samples whose load raises; the dropped slots are filled from the epoch's
    remaining indices, so every batch stays full. ``collate(samples)``
    replaces the default ``np.stack`` of each field."""
    n = len(dataset)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    if fraction < 1.0:
        idx = idx[: max(1, int(n * fraction))]
    idx = [int(j) for j in idx]

    def assemble(samples):
        if collate is not None:
            return collate(samples)
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0].keys()}

    def load(j):
        if not skip_errors:
            return dataset[j]
        try:
            return dataset[j]
        except Exception as e:  # noqa: BLE001 — per-sample resilience
            print(f"warning: sample {j} failed to load ({type(e).__name__}: {e})")
            return None

    if num_workers <= 0:
        buf = []
        for j in idx:
            s = load(j)
            if s is None:
                continue
            buf.append(s)
            if len(buf) == batch_size:
                yield assemble(buf)
                buf = []
        if buf and not drop_last:
            yield assemble(buf)
        return

    if worker_mode == "process":
        # cached across calls (see _get_process_pools): not closed here
        pools = _get_process_pools(dataset, num_workers)
        epoch = getattr(dataset, "epoch", None)
        submit = lambda j: pools[j % len(pools)].submit(  # noqa: E731
            _pool_load, (j, skip_errors, epoch))
        owns_pool = False
    elif worker_mode == "thread":
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers)
        submit = lambda j: pool.submit(load, j)  # noqa: E731
        owns_pool = True
    else:
        raise ValueError(f"unknown worker_mode '{worker_mode}'")

    lookahead = max(batch_size * max(1, prefetch), num_workers)
    try:
        futures = deque(submit(j) for j in idx[:lookahead])
        pending = deque(idx[lookahead:])
        buf = []
        while futures:
            s = futures.popleft().result()
            if pending:
                futures.append(submit(pending.popleft()))
            if s is None:
                continue
            buf.append(s)
            if len(buf) == batch_size:
                yield assemble(buf)
                buf = []
        if buf and not drop_last:
            yield assemble(buf)
    finally:
        if owns_pool:
            pool.shutdown(wait=True)


def end_of_epoch_outputs(out_dir: str, state: TrainState, cfg, epoch: int,
                         last_epoch: bool, best_val: float) -> float:
    """The JAX trainers' checkpoint cadence: ``best_model`` whenever the
    validation loss improves, ``epoch_N`` and ``final_model`` every
    ``save_checkpoint_every`` epochs and at the last, the history plots every
    ``plot_history_every``. Checkpoints go to ``out_dir/cfg.output.checkpoint_dir``.
    Returns the best validation loss so far."""
    ckpt_dir = os.path.normpath(os.path.join(out_dir, cfg.output.checkpoint_dir))
    os.makedirs(ckpt_dir, exist_ok=True)
    val = state.history[-1].get("val_loss") if state.history else None
    if val is not None and val < best_val:
        save_checkpoint(ckpt_dir, state, cfg, name="best_model")
        print(f"epoch {epoch}: new best val_loss {val:.5f} -> best_model")
        best_val = val
    if (epoch + 1) % cfg.output.save_checkpoint_every == 0 or last_epoch:
        save_checkpoint(ckpt_dir, state, cfg, name=f"epoch_{epoch}")
        save_checkpoint(ckpt_dir, state, cfg, name="final_model")
        print(f"checkpoint saved (epoch_{epoch} + final_model)")
    if (epoch + 1) % cfg.output.plot_history_every == 0 or last_epoch:
        plot_training_history(state.history, os.path.join(out_dir, cfg.output.plots_dir))
    return best_val


def plot_training_history(history: List[Dict[str, float]], out_dir: str):
    """Loss, learning-rate, loss-component and IEF-delta curves of
    ``TrainState.history`` as PNG files (``utils/plotting.py``, the JAX
    package's files and sizes); returns their paths."""
    from smilify_tpu_torch.utils import plotting

    if not history:
        return []
    os.makedirs(out_dir, exist_ok=True)
    epochs = [h.get("epoch", i) for i, h in enumerate(history)]
    written = []

    def plot(name, curves, ylabel, title, figsize, log=True):
        fig, ax = plotting.subplots(figsize=figsize)
        for label, values in curves:
            ax.plot(epochs, values, label=label)
        ax.set_xlabel("epoch")
        if ylabel:
            ax.set_ylabel(ylabel)
        if log:
            ax.set_yscale("log")
        if len(curves) > 1:
            ax.legend(fontsize=7)
        ax.set_title(title)
        ax.grid(alpha=0.3)
        p = os.path.join(out_dir, name)
        fig.savefig(p, dpi=120)
        written.append(p)

    plot("training_history.png", [("loss", [h["loss"] for h in history])], "loss",
         "training loss", (7, 4), log=False)
    if any("lr" in h for h in history):
        plot("lr_schedule.png", [("lr", [h.get("lr", float("nan")) for h in history])], "lr",
             "learning rate schedule", (7, 3))
    for prefix, name, title in (("loss_", "loss_components.png", "loss components"),
                                ("ief_", "ief_deltas.png", "IEF estimate-delta norms")):
        keys = sorted({k for h in history for k in h if k.startswith(prefix)})
        if keys:
            plot(name, [(k[len(prefix):], [h.get(k, float("nan")) for h in history]) for k in keys],
                 None, title, (8, 4))
    return written


# the IEF head's estimate-embedding parameters (reset_ief_token_embedding)
_IEF_TOKEN_PARAMS = ("init_estimate", "estimate_embed", "estimate_norm")


def try_resume(ckpt_dir: str, resume: Optional[str], state: TrainState,
               model: torch.nn.Module, reset_ief_token_embedding: bool = False):
    """Resume the model's parameters and statistics, the optimizer state and
    the epoch from a checkpoint: ``resume`` is a checkpoint name within
    ``ckpt_dir`` or a path, without extension. Returns ``(state, start_epoch)``.

    ``reset_ief_token_embedding`` keeps the model's fresh values for the IEF
    head's estimate-embedding parameters (the checkpoint-migration flag)."""
    if not resume:
        return state, 0
    path = resume if os.path.isabs(resume) else os.path.join(ckpt_dir, resume)
    path = os.path.abspath(path)
    payload, meta = load_checkpoint(path)
    restored = payload["model"]
    if reset_ief_token_embedding:
        from smilify_tpu_torch.models.weight_port import flax_module_paths

        paths = flax_module_paths(model)
        fresh = model.state_dict()
        restored = {k: fresh[k] if any(s in paths.get(k, k) or s in k for s in _IEF_TOKEN_PARAMS)
                    else v for k, v in restored.items()}
        print("reset IEF token-embedding params to fresh init (migration)")
    model.load_state_dict(restored)
    state.model_state = model.state_dict()
    if payload.get("opt_state") is not None:
        state.opt_state = payload["opt_state"]
    start_epoch = 0
    if meta:
        start_epoch = int(meta.get("epoch", -1)) + 1
        state.history = list(meta.get("history", []))
    print(f"resumed from {path} at epoch {start_epoch}")
    return state, start_epoch


def _batch_signature(batch) -> Tuple:
    return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()
                        if isinstance(v, torch.Tensor)))


def train_epochs(model: torch.nn.Module, cfg, apply_fn: Callable, make_loss: Callable,
                 train_ds, val_ds, batch_size: int, device: torch.device, out_dir: str,
                 state: TrainState, start_epoch: int = 0,
                 visualize: Optional[Callable] = None, mesh=None) -> TrainState:
    """The JAX trainer CLIs' epoch loop, shared by both ports.

    Each epoch: the curriculum's loss weights and learning rate and the
    backbone's freeze; a new optimizer (fresh Adam moments) and new step
    functions whenever (weights, lr, frozen) changes; batches from a
    :class:`DeviceDataCache` (``training.device_data_cache``, augmentation
    off) or from :func:`iterate_batches` through a :class:`StagingCollator`
    (skip_errors); per-batch resilience (a failing batch is skipped and
    counted, and the error raised once the skips outnumber max(4, the steps
    so far)); the validation loss; ``visualize(epoch) -> metrics`` on the
    visualization cadence; :func:`end_of_epoch_outputs`. ``make_loss(weights)``
    builds ``loss_fn(preds, batch)``.

    With a ``('data',)`` ``mesh`` of several ranks (:func:`data_mesh`),
    ``batch_size`` is the global batch: the device cache gives each rank its
    rows of every global batch, the host pipeline a strided shard of the
    dataset (:func:`~smilify_tpu_torch.train.multihost.shard_dataset_for_process`)
    and the local share of the batch. Before each step the ranks agree on
    two flags over a host (gloo) group: whether every rank has a batch (the
    epoch ends when one has none) and whether one failed to prepare its
    batch (device copy, or keys and shapes unlike the first batch's): then
    every rank skips it and the skip counts agree. A step that raises after
    that is not skipped: the other ranks are inside its collectives.
    Checkpoints, plots and visualizations are written by rank 0."""
    from smilify_tpu_torch.train.multihost import (
        axis_group,
        host_group,
        is_primary,
        shard_dataset_for_process,
    )

    group, n_ranks, _ = axis_group(mesh, "data")
    distributed = n_ranks > 1
    flags_group = host_group(group) if distributed else None
    accum = cfg.training.gradient_accumulation_steps
    bs = batch_size
    host_rng = np.random.default_rng(cfg.training.seed)
    staging = StagingCollator()
    device_cache = val_cache = None
    if cfg.training.device_data_cache:
        if cfg.augmentation.enabled:
            print("device_data_cache disabled: needs augmentation off — falling back to the "
                  "host pipeline")
        else:
            device_cache = DeviceDataCache(train_ds, device)
            if len(val_ds) >= bs:
                val_cache = DeviceDataCache(val_ds, device)
            print(f"device data cache: {len(train_ds)} train samples, "
                  f"{device_cache.bytes / 1e6:.0f} MB resident on {device}")
    rows = rank_rows(bs, mesh, accum) if distributed else None
    host_bs, val_bs = bs, bs
    if distributed and device_cache is None:
        host_bs, train_ds = shard_dataset_for_process(train_ds, bs)
        val_bs, val_ds = shard_dataset_for_process(val_ds, bs) if len(val_ds) >= bs else (bs, val_ds)

    def to_device(host_batch):
        return narrow_floats(staging.to_device(host_batch, device))

    def agree(have: bool, failed: bool):
        """(every rank has a batch, some rank failed to prepare its batch)."""
        if not distributed:
            return have, failed
        flags = torch.tensor([int(have), int(failed)], dtype=torch.int32)
        torch.distributed.all_reduce(flags, group=flags_group)
        return int(flags[0]) == n_ranks, int(flags[1]) > 0

    current = {"key": None}
    t_start = time.time()
    best_val = min((h.get("val_loss", float("inf")) for h in state.history), default=float("inf"))
    for epoch in range(start_epoch, cfg.training.num_epochs):
        if hasattr(train_ds, "set_epoch"):
            train_ds.set_epoch(epoch)
        weights = cfg.get_loss_weights_for_epoch(epoch)
        lr = cfg.get_learning_rate_for_epoch(epoch)
        frozen = cfg.model.freeze_backbone and (
            cfg.model.backbone_unfreeze_epoch is None or epoch < cfg.model.backbone_unfreeze_epoch)
        key = (tuple(sorted(weights.items())), lr, frozen)
        if key != current["key"]:
            opt = build_optimizer(cfg, lr, frozen, model)
            loss_fn = make_loss(dict(weights))
            current.update(key=key, opt=opt,
                           step_fn=make_train_step(model, apply_fn, loss_fn, opt, accum, mesh),
                           eval_fn=make_eval_step(model, apply_fn, loss_fn, mesh))
            print(f"epoch {epoch}: lr={lr} frozen_backbone={frozen}")

        losses, objs, skipped, signature = [], {}, 0, None
        if device_cache is not None:
            batch_iter = device_cache.iterate(bs, host_rng, fraction=cfg.dataset.dataset_fraction,
                                              rows=rows)
        else:
            batch_iter = iterate_batches(train_ds, host_bs, host_rng,
                                         fraction=cfg.dataset.dataset_fraction, collate=staging,
                                         num_workers=cfg.training.num_workers,
                                         prefetch=cfg.training.prefetch_factor,
                                         worker_mode=cfg.training.worker_mode, skip_errors=True)
        batches = iter(batch_iter)
        while True:
            # per-batch resilience, as the JAX trainers have it
            batch, error = next(batches, None), None
            if batch is not None:
                try:
                    if device_cache is None:
                        batch = to_device(batch)
                    if distributed:
                        signature = signature or _batch_signature(batch)
                        if _batch_signature(batch) != signature:
                            raise ValueError("batch keys or shapes differ from the first batch's")
                except Exception as e:  # noqa: BLE001
                    error = e
            have_all, failed = agree(batch is not None, error is not None)
            if not have_all:
                break
            if not failed:
                try:
                    loss, objs = current["step_fn"](batch)
                    losses.append(loss)          # a device scalar: no read-back a step
                    state.step += 1
                    continue
                except Exception as e:  # noqa: BLE001
                    if distributed:
                        raise
                    error = e
            skipped += 1
            print(f"warning: skipped batch ({type(error).__name__}: {error})" if error else
                  "warning: skipped batch (another rank failed to prepare its batch)")
            if skipped > max(4, len(losses)):
                raise error or RuntimeError("batches keep failing on another rank")
        if skipped:
            print(f"epoch {epoch}: skipped {skipped} failing batches")
        if not losses:
            raise SystemExit("no batches — dataset smaller than batch size?")
        mean_loss = float(np.mean([float(v) for v in losses]))
        state.epoch = epoch
        state.history.append({"epoch": epoch, "loss": mean_loss, "lr": lr})
        for k, v in objs.items():
            state.history[-1][f"loss_{k}"] = float(v)
        print(f"epoch {epoch}: loss {mean_loss:.5f} ({len(losses)} steps, "
              f"{time.time() - t_start:.0f}s)")

        if len(val_ds) >= val_bs:
            if val_cache is not None:
                val_iter = val_cache.iterate(bs, host_rng, shuffle=False, rows=rows)
            else:
                val_iter = (to_device(vb) for vb in iterate_batches(
                    val_ds, val_bs, host_rng, shuffle=False, fraction=1.0, collate=staging))
            val_losses = [float(current["eval_fn"](vb)[0]) for vb in val_iter]
            if val_losses:
                state.history[-1]["val_loss"] = float(np.mean(val_losses))
                print(f"epoch {epoch}: val_loss {state.history[-1]['val_loss']:.5f}")

        last_epoch = epoch == cfg.training.num_epochs - 1
        state.model_state = model.state_dict()
        state.opt_state = current["opt"].state_dict()
        if is_primary():
            if visualize is not None and (
                    (epoch + 1) % cfg.output.generate_visualizations_every == 0 or last_epoch):
                state.history[-1].update(visualize(epoch))
            best_val = end_of_epoch_outputs(out_dir, state, cfg, epoch, last_epoch, best_val)
    return state
