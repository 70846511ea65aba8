"""The serving layer (port of ``smilify_tpu/serve.py`` and the loader of
``smilify_tpu/cli/run_inference.py``): :func:`load_model_from_checkpoint`
and :func:`predictor` serve the regressors' step
(``models/predict.py::decoded``) live, for the inference CLIs;
:func:`export_serving_artifact` loads a training checkpoint, wraps the same
step (:func:`build_predict_fn`) and captures it with
``torch.export.export``: the graph, with the weights inside the exported
program, for each requested device. The one file is a zip container that
holds one ``torch.export.save`` program a device (``cuda``, ``cpu``)
beside its metadata; a ``.json`` sidecar repeats the metadata.
:class:`ServingModel` / :func:`load_serving_artifact` run it with ``torch``
and this module alone: no model classes, no config system and no checkpoint
reader are imported (this module imports them only to export and to serve
live). The artifact also freezes the numerics: it replays the captured
computation even if the model code changes later.

One program a device, not one moved between devices: the backbone's
autocast region records its device type in the graph. The batch is fixed
(``batch_size > 0``) or symbolic (``batch_size=0``: one program serves any
batch from 1 up; it is captured at a batch of 2, so that the 1 of a
single-image batch is not specialized into it). ``view_mask`` and
``camera_ids`` enter as tensors of the batch's shape; nothing in the graph
depends on their values' count.

``shard_data=True`` replicates the one program onto each of ``n_devices``
visible cards: a batch is split along its leading axis, each part served on
its own card, and the outputs joined on the first. The loader raises when
fewer cards are visible than the artifact names.

Outputs are the decoded prediction dict of ``decode_predictions`` (or the
multi-view one) less ``ief_history``: axis-angle rotations, betas, trans,
per-view cameras — what the inference CLI consumes.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Sequence

import torch

FORMAT_VERSION = 1
_META = "meta.json"
EXAMPLE_BATCH = 2     # the batch a symbolic program is captured at (not 0 or 1)
MAX_BATCH = 1 << 16


def discover_checkpoint(path: str) -> str:
    """Resolve a run directory to its best checkpoint: ``best_model`` first,
    then ``final_model``, then the newest ``epoch_N``, in the run root and
    then its ``checkpoints/``. A path that is already a checkpoint (has a
    ``.meta.json`` beside it) is returned unchanged."""
    if os.path.exists(path + ".meta.json"):
        return path
    if not os.path.isdir(path):
        return path
    for root in (path, os.path.join(path, "checkpoints")):
        if not os.path.isdir(root):
            continue
        for name in ("best_model", "final_model"):
            cand = os.path.join(root, name)
            if os.path.exists(cand + ".meta.json"):
                print(f"auto-discovered checkpoint: {cand}")
                return cand
        epochs = sorted(
            (int(n.split("_")[1].split(".")[0]), n.split(".")[0]) for n in os.listdir(root)
            if n.startswith("epoch_") and n.endswith(".meta.json")
            and n.split("_")[1].split(".")[0].isdigit())
        if epochs:
            cand = os.path.join(root, epochs[-1][1])
            print(f"auto-discovered checkpoint: {cand}")
            return cand
    return path


def load_model_from_checkpoint(ckpt_path: str, device="cuda"):
    """(model in eval mode on ``device``, TrainingConfig, regressor config,
    ModelSpec on ``device``, meta) from a checkpoint or a run directory
    (resolved by :func:`discover_checkpoint`)."""
    from smilify_tpu_torch._device import resolve_device
    from smilify_tpu_torch.models.weight_port import build_model
    from smilify_tpu_torch.train.config import config_from_dict, resolve_model_spec
    from smilify_tpu_torch.train.trainer import load_checkpoint

    dev = resolve_device(device)
    ckpt_path = discover_checkpoint(ckpt_path)
    with open(ckpt_path + ".meta.json") as f:
        meta = json.load(f)
    cfg = config_from_dict(meta["config"])
    spec = resolve_model_spec(cfg, device=dev)
    rcfg = cfg.regressor_config(spec)
    model = build_model(rcfg, img_size=cfg.model.input_resolution or 224)
    payload, _ = load_checkpoint(ckpt_path)
    model.load_state_dict(payload["model"])
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, cfg, rcfg, spec, meta


def predictor(model, rcfg, spec, multiview: bool):
    """``predict(batch)`` → decoded predictions for a batch of device
    tensors (``image``, or ``images``/``view_mask``/``camera_indices``).

    On a card a call replays a CUDA graph of the model and the decode once
    its inputs' ``graph_key`` has been seen (``utils/graphs.py``'s
    :class:`~smilify_tpu_torch.utils.graphs.Replayer`): the key's first call
    runs eagerly (cuDNN's choices, lazy set-up, the allocator), its second
    captures the graph and replays it, later ones copy their inputs into
    the graph's and replay. The same kernels run on the same numbers either
    way, and every call returns tensors of its own. On the CPU every call
    runs eagerly. Counted while recording: ``infer.graph.eager``,
    ``infer.graph.captures``, ``infer.graph.replays``."""
    from smilify_tpu_torch.models.predict import decoded, input_names
    from smilify_tpu_torch.utils import monitoring
    from smilify_tpu_torch.utils.graphs import Replayer

    names = input_names(multiview)
    replay = Replayer(lambda inputs: decoded(model, rcfg, spec, inputs)[0], "infer.graph")

    @torch.no_grad()
    def predict(batch):
        with monitoring.span("infer.predict"):
            return replay({k: batch[k] for k in names})

    return predict


class Predict(torch.nn.Module):
    """The model's inputs in ``models/predict.py::input_names``' order →
    the decoded predictions less ``ief_history``."""

    def __init__(self, model, rcfg, spec):
        super().__init__()
        self.model, self.rcfg, self.spec = model, rcfg, spec

    def forward(self, *inputs):
        from smilify_tpu_torch.models.predict import decoded, input_names, is_multiview

        names = input_names(is_multiview(self.model))
        return decoded(self.model, self.rcfg, self.spec, dict(zip(names, inputs)))[0]


def build_predict_fn(model, rcfg, spec) -> torch.nn.Module:
    """The checkpoint's inference step as a module of the model's inputs:
    ``models/predict.py::decoded``, as :func:`predictor` runs it, with
    ``ief_history`` dropped (the decode leaves it out)."""
    return Predict(model, rcfg, spec).eval()


def example_inputs(res: int, batch: int, n_views: Optional[int], device) -> tuple:
    """Inputs of the predict signature: zeros images, every view on, the
    views' camera ids in order."""
    dev = torch.device(device)
    if n_views is None:
        return (torch.zeros((batch, res, res, 3), device=dev),)
    return (torch.zeros((batch, n_views, res, res, 3), device=dev),
            torch.ones((batch, n_views), dtype=torch.bool, device=dev),
            torch.arange(n_views, dtype=torch.int32, device=dev).repeat(batch, 1))


def export_program(predict: Predict, inputs: tuple, symbolic: bool):
    """``torch.export`` of ``predict`` on ``inputs``; a symbolic batch
    through ``torch.export.Dim`` when ``symbolic`` (one entry for
    ``forward``'s one parameter, ``*inputs``)."""
    dynamic = None
    if symbolic:
        batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
        dynamic = (tuple({0: batch} for _ in inputs),)
    with torch.no_grad():
        return torch.export.export(predict, inputs, dynamic_shapes=dynamic)


def export_serving_artifact(
    checkpoint: str,
    out_path: str,
    batch_size: int = 0,
    platforms: Sequence[str] = ("cuda", "cpu"),
    shard_data: bool = False,
    n_devices: Optional[int] = None,
) -> Dict[str, Any]:
    """Checkpoint → serving artifact at ``out_path`` (+ ``.json`` sidecar).
    Returns the metadata. ``batch_size=0`` exports a symbolic batch;
    ``platforms`` names the devices, one program each; ``shard_data`` marks
    the artifact for replication over ``n_devices`` (default: every visible
    card) replicas, a fixed batch divisible by their count, each replica's
    program serving its share."""
    from smilify_tpu_torch._device import resolve_device

    n_dev = 1
    if shard_data:
        n_dev = n_devices or max(1, torch.cuda.device_count())
        if batch_size == 0 or batch_size % n_dev:
            raise ValueError(f"shard_data needs a fixed batch divisible by the {n_dev} "
                             f"replicas, got batch_size={batch_size}")
    per_device = batch_size // n_dev
    programs, meta = {}, None
    for platform in platforms:
        dev = resolve_device(platform)
        model, cfg, rcfg, spec, _ = load_model_from_checkpoint(checkpoint, device=dev)
        is_mv = cfg.mode == "multi_view"
        res = cfg.model.input_resolution or 224
        n_views = rcfg.max_views if is_mv else None
        predict = build_predict_fn(model, rcfg, spec)
        inputs = example_inputs(res, per_device or EXAMPLE_BATCH, n_views, dev)
        ep = export_program(predict, inputs, symbolic=batch_size == 0)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[dev.type] = buf.getvalue()
        with torch.no_grad():
            keys = sorted(predict(*inputs))
        meta = {
            "format_version": FORMAT_VERSION,
            "mode": cfg.mode,
            "input_resolution": res,
            "n_views": n_views,
            "batch_size": batch_size or "symbolic",
            "data_sharded": bool(shard_data),
            "n_devices": n_dev,
            "platforms": list(platforms),
            "backbone": cfg.model.backbone_name,
            "output_keys": keys,
            "torch_version": torch.__version__,
            "checkpoint": os.path.abspath(checkpoint),
        }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_META, json.dumps(meta))
        for name, blob in programs.items():
            zf.writestr(f"{name}.pt2", blob)
    meta["artifact_bytes"] = os.path.getsize(out_path)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class ServingModel:
    """A loaded artifact: ``ServingModel(path)(images, ...) → preds`` (a
    dict of tensors on the serving device; numpy inputs are accepted).

    ``device`` picks the program: ``cuda`` (the default; raises when no
    card is visible) or ``cpu``, which the caller asks for. A
    ``shard_data`` artifact is loaded once a replica (``cuda:0``,
    ``cuda:1``, ... or the host) and raises when fewer cards are visible
    than it names."""

    def __init__(self, path: str, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            # resolve_device's check, inlined: the loader imports no other module of the port
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        with zipfile.ZipFile(path) as zf:
            self.meta = json.loads(zf.read(_META))
            names = {n[:-4] for n in zf.namelist() if n.endswith(".pt2")}
            if dev.type not in names:
                raise ValueError(f"artifact has programs for {sorted(names)}, not {dev.type}")
            blob = zf.read(f"{dev.type}.pt2")
        devices = [dev]
        if self.meta.get("data_sharded"):
            need = self.meta["n_devices"]
            if dev.type == "cuda":
                have = torch.cuda.device_count()
                if have < need:
                    raise RuntimeError(f"artifact was exported for {need} cards; {have} visible")
                devices = [torch.device("cuda", i) for i in range(need)]
            else:
                devices = [dev] * need    # replicas on the host (the split is the same)
        self.devices = devices
        self._replicas = []
        for d in devices:
            ep = torch.export.load(io.BytesIO(blob))
            if d.type == "cuda" and d != torch.device("cuda", 0):
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, {"cuda:0": str(d)})
            self._replicas.append(ep.module())

    def __call__(self, *args) -> Dict[str, torch.Tensor]:
        args = [torch.as_tensor(a) for a in args]
        with torch.no_grad():
            if len(self._replicas) == 1:
                return self._replicas[0](*(a.to(self.devices[0]) for a in args))
            parts = [torch.chunk(a, len(self._replicas)) for a in args]
            outs = [m(*(p[i].to(d) for p in parts))
                    for i, (m, d) in enumerate(zip(self._replicas, self.devices))]
            return {k: torch.cat([o[k].to(self.devices[0]) for o in outs]) for k in outs[0]}


def load_serving_artifact(path: str, device="cuda") -> ServingModel:
    return ServingModel(path, device)
