"""Serving export: freeze the inference step into one self-contained
artifact (port of ``smilify_tpu/serve.py``).

:func:`export_serving_artifact` loads a training checkpoint, wraps the model
and its decode (:func:`build_predict_fn`, the same computation as
``cli/run_inference.py::predictor``) and captures it with
``torch.export.export``: the graph, with the weights inside the exported
program, for each requested device. The one file is a zip container that
holds one ``torch.export.save`` program a device (``cuda``, ``cpu``)
beside its metadata; a ``.json`` sidecar repeats the metadata.
:class:`ServingModel` / :func:`load_serving_artifact` run it with ``torch``
and this module alone: no model classes, no config system and no checkpoint
reader are imported (this module imports them only to export). The
artifact also freezes the numerics: it replays the captured computation
even if the model code changes later.

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


class _Predict(torch.nn.Module):
    """images (B, H, W, 3) → the decoded predictions less ``ief_history``."""

    def __init__(self, model, rcfg, spec):
        super().__init__()
        self.model, self.rcfg, self.spec = model, rcfg, spec

    def forward(self, images):
        from smilify_tpu_torch.models.regressor import decode_predictions, float32_region

        raw, _ = self.model(images)
        with float32_region(images.device):
            return decode_predictions(self.rcfg, raw, self.spec)


class _PredictMultiView(_Predict):
    """images (B, V, H, W, 3), view_mask (B, V) bool, camera ids (B, V) →
    the decoded multi-view predictions less ``ief_history``."""

    def forward(self, images, view_mask, camera_ids):
        from smilify_tpu_torch.models.multiview import decode_multiview_predictions
        from smilify_tpu_torch.models.regressor import float32_region

        raw, _ = self.model(images, view_mask, camera_ids)
        with float32_region(images.device):
            return decode_multiview_predictions(self.rcfg, raw, self.spec)


def build_predict_fn(model, rcfg, spec, is_mv: bool) -> torch.nn.Module:
    """The checkpoint's inference step as a module of the image batch (and,
    multi-view, the view mask and camera ids): the computation of
    ``cli/run_inference.py::predictor`` with ``ief_history`` dropped (the
    decode leaves it out)."""
    return (_PredictMultiView if is_mv else _Predict)(model, rcfg, spec).eval()


def example_inputs(res: int, batch: int, n_views: Optional[int], device) -> tuple:
    """Inputs of the predict signature: zeros images, every view on, the
    views' camera ids in order."""
    dev = torch.device(device)
    if n_views is None:
        return (torch.zeros((batch, res, res, 3), device=dev),)
    return (torch.zeros((batch, n_views, res, res, 3), device=dev),
            torch.ones((batch, n_views), dtype=torch.bool, device=dev),
            torch.arange(n_views, dtype=torch.int32, device=dev).repeat(batch, 1))


def export_program(predict: torch.nn.Module, inputs: tuple, symbolic: bool):
    """``torch.export`` of ``predict`` on ``inputs``; a symbolic batch
    through ``torch.export.Dim`` when ``symbolic``."""
    dynamic = None
    if symbolic:
        batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
        dynamic = tuple({0: batch} for _ in inputs)
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
    from smilify_tpu_torch.cli.run_inference import load_model_from_checkpoint

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
        predict = build_predict_fn(model, rcfg, spec, is_mv)
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
