"""The regressors' step, written once: the model called on its named inputs,
then its raw outputs decoded in float32 under the span ``model.decode``.
The trainers' apply functions, ``serve.py``'s predictor and exported
program, and the benches all run :func:`decoded`."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from smilify_tpu_torch.models import multiview as mv_model
from smilify_tpu_torch.models import regressor as sv_model
from smilify_tpu_torch.utils import monitoring


def input_names(multiview: bool) -> Tuple[str, ...]:
    """The batch keys the model reads, in the order of its call."""
    return ("images", "view_mask", "camera_indices") if multiview else ("image",)


def is_multiview(model: torch.nn.Module) -> bool:
    """Whether ``model`` (or the module a ``DistributedDataParallel`` wraps)
    is the multi-view regressor."""
    return isinstance(getattr(model, "module", model), mv_model.MultiViewSMILRegressor)


def decoded(model, rcfg, spec, inputs: Dict[str, torch.Tensor],
            gt_cameras: Optional[Dict[str, torch.Tensor]] = None):
    """(decoded predictions, IEF history) of ``model`` on ``inputs`` (a dict
    holding :func:`input_names`' keys). ``gt_cameras`` initialize the
    multi-view camera head's delta mode; the single-view model takes none."""
    mv = is_multiview(model)
    args = [inputs[k] for k in input_names(mv)]
    if mv:
        raw, history = model(*args, gt_cameras=gt_cameras)
    else:
        raw, history = model(*args)
    # the decode is read off its module at each call, so that a patch of it
    # (portbench's infer fault `altered`) reaches every caller
    decode = mv_model.decode_multiview_predictions if mv else sv_model.decode_predictions
    with monitoring.span("model.decode"), sv_model.float32_region(args[0].device):
        return decode(rcfg, raw, spec), history
