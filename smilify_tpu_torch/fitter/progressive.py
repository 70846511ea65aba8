"""Coarse-to-fine (progressive-resolution) fitting (port of
``smilify_tpu/fitter/progressive.py``).

The reference runs every optimization stage at the full image size. This
fitter runs early raster stages on a downsampled silhouette pyramid and hands
the parameters up to the next resolution: a 4×-downsampled soft silhouette is
in effect a 4×-blurred one, so early stages see gradient signal from farther
away. It is a convergence knob; whether it saves time on the card is what
``smilify_tpu_torch.tools.bench_progressive`` measures.

Loss semantics: the silhouette term is a per-pixel mean and the priors and
temporal terms act on parameters (all resolution invariant), but the 2D joint
term is squared pixel error, which scales by 1/s² when the image scales by
1/s. :func:`scaled_weights` multiplies ``w_j2d`` by s² so the term ratios
match the full-resolution schedule at every scale.

Each distinct scale is its own :class:`~smilify_tpu_torch.fitter.fitter.SmalFitter`;
parameters pass between them, and each stage starts a fresh Adam as the
reference's per-stage optimizer rebuilds do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from smilify_tpu_torch.fitter.fitter import FitData, SmalFitter
from smilify_tpu_torch.fitter.stages import OPT_WEIGHTS, StageWeights

# the raster-free stage 0 runs at scale 1; this default maps the reference
# 4-stage table to a 4× → 2× → full pyramid
DEFAULT_SCALES = (1, 4, 2, 1)


def downsample_fit_data(data: FitData, scale: int) -> FitData:
    """Area-average the silhouette targets and scale the pixel-space joints
    by ``1/scale``. The image dims must be divisible by ``scale``;
    visibility and rgb (host-side, for display only) pass through."""
    if scale == 1:
        return data
    sil = data.sil
    if sil is not None:
        sil = torch.as_tensor(sil)
        H, W = sil.shape[-2], sil.shape[-1]
        if H % scale or W % scale:
            raise ValueError(f"image size ({H}, {W}) not divisible by pyramid scale {scale}")
        lead = tuple(sil.shape[:-2])
        sil = sil.reshape(*lead, H // scale, scale, W // scale, scale).mean(dim=(-3, -1))
    joints = data.joints if data.joints is None else torch.as_tensor(data.joints) / scale
    return data._replace(sil=sil, joints=joints)


def scaled_weights(weights: StageWeights, scale: int) -> StageWeights:
    """Keep the loss-term ratios across the pyramid: the joint term is
    squared pixel error (it scales by 1/s² when coordinates scale by 1/s);
    every other term is resolution invariant."""
    if scale == 1:
        return weights
    return weights._replace(w_j2d=weights.w_j2d * scale * scale)


class ProgressiveFitter:
    """Drives one :class:`SmalFitter` per pyramid scale, sharing parameters.

    Presents the ``run_stage``/``fit`` surface of ``SmalFitter``;
    ``fitter`` is the full-resolution instance (it holds the canonical
    parameters and serves rendering and export). ``fitter_kwargs`` (device,
    raster mode, priors) go to every scale's fitter."""

    def __init__(
        self,
        spec,
        data: FitData,
        image_size: Tuple[int, int],
        scales: Sequence[int] = DEFAULT_SCALES,
        **fitter_kwargs,
    ):
        self.spec = spec
        self.image_size = tuple(image_size)
        self.scales = tuple(int(s) for s in scales)
        if any(s < 1 for s in self.scales):
            raise ValueError(f"pyramid scales must be >= 1, got {self.scales}")
        self._data = data
        self._kwargs = dict(fitter_kwargs)
        self._fitters = {1: SmalFitter(spec, data, self.image_size, **self._kwargs)}

    @property
    def fitter(self) -> SmalFitter:
        """The full-resolution fitter (canonical parameter holder)."""
        return self._fitters[1]

    @property
    def n_frames(self) -> int:
        return self._fitters[1].n_frames

    @property
    def params(self):
        return self._fitters[1].params

    @params.setter
    def params(self, value):
        self._fitters[1].params = value

    def _fitter_at(self, scale: int) -> SmalFitter:
        if scale not in self._fitters:
            H, W = self.image_size
            self._fitters[scale] = SmalFitter(
                self.spec, downsample_fit_data(self._data, scale),
                (H // scale, W // scale), **self._kwargs)
        return self._fitters[scale]

    def run_stage(self, stage_id: int, weights: StageWeights, callback=None,
                  chunk: int = 1, scale: Optional[int] = None):
        if scale is None:
            scale = self.scales[stage_id] if stage_id < len(self.scales) else 1
        f = self._fitter_at(scale)
        f.params = self._fitters[1].params
        loss = f.run_stage(stage_id, scaled_weights(weights, scale),
                           callback=callback, chunk=chunk)
        self._fitters[1].params = f.params
        return loss

    def fit(self, schedule: Optional[List[StageWeights]] = None, callback=None,
            chunk: int = 1):
        schedule = schedule if schedule is not None else OPT_WEIGHTS
        return [self.run_stage(i, w, callback=callback, chunk=chunk)
                for i, w in enumerate(schedule)]

    def forward_frames(self):
        return self._fitters[1].forward_frames()
