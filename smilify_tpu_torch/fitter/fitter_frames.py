"""Frame-sharded fitting: ONE long sequence optimized across ranks (port of
``smilify_tpu/fitter/fitter_frames.py``).

The JAX package runs the step under ``shard_map`` on a ``('frames',)``
mesh. Here each rank is a process that holds N/D consecutive frames of the
sequence, and the step's collectives are explicit calls on the mesh's
``frames`` group:

  * per-frame parameters (global_rot, joint_rot, trans, fov) live on the
    rank that owns their frames; their gradients stay local;
  * sequence-shared parameters (betas, log_beta_scales, joint_trans) are
    replicated; after ``backward()`` one ``all_reduce`` sums their partial
    gradients (:func:`psum_shared_grads`), the only collective of a step's
    update;
  * loss terms normalized by a mean over frames or pixels are scaled by 1/D
    on each rank, so the sum over ranks of the local losses, and every local
    gradient, equal the unsharded ones; sum-normalized terms (splay,
    temporal) are plain partial sums;
  * the temporal pair that straddles two ranks uses the next rank's first
    frame, exchanged in the forward; the exchange's backward sends the
    pair's gradient back to the rank that owns that frame
    (:func:`temporal_losses_halo`);
  * Adam runs on every rank on its own leaves; the shared leaves stay equal
    because their gradients are reduced before the update;
  * the reported loss and terms are all-reduced once a chunk of steps (one
    collective and one read-back a chunk);
  * each rank's raster runs the raster kernels on its own frames (K1/K2
    exact, K3/K4 capped).

The single-process fit is the reference (``tests/test_torch_sharded_fitters.py``,
held against the JAX package's unsharded fit).
"""

from __future__ import annotations

import functools

import torch

from smilify_tpu_torch.fitter.fitter import FitData, FitParams, SmalFitter, forward_losses
from smilify_tpu_torch.fitter.stages import StageWeights
from smilify_tpu_torch.train.multihost import (
    all_gather_stack,
    all_reduce_sum,
    allgather,
    axis_group,
    globalize,
    make_mesh,
    process_count,
)
from smilify_tpu_torch.utils import monitoring

# loss terms normalized by a mean over frames/pixels (a global count): each
# rank's value is scaled by 1/D so that the sum over ranks is exact; 'splay'
# and the temporal terms are sums over frames/pairs and add up as they are
_FRAME_MEAN_TERMS = frozenset({"joint", "limit", "pose", "betas", "sil_reproj"})

# FitParams fields shared across the frame axis: the only gradients that
# need a collective when frames are sharded
_SHARED_PARAM_FIELDS = ("betas", "log_beta_scales", "joint_trans")


def psum_shared_grads(leaves: dict, group) -> None:
    """Sum the frame ranks' partial gradients of the sequence-shared leaves
    in place: one ``all_reduce`` of their gradients packed together."""
    grads = [leaves[f].grad for f in _SHARED_PARAM_FIELDS]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum(flat, group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _NextFirstFrame(torch.autograd.Function):
    """The next rank's first-frame rows (zeros on the last rank). Its
    backward is the reverse exchange: the gradient a rank took for the rows
    it received goes back to the rank that owns them."""

    @staticmethod
    def forward(ctx, first, group, size, rank):
        ctx.group, ctx.rank = group, rank
        every = all_gather_stack(first, group)
        return every[rank + 1].clone() if rank + 1 < size else torch.zeros_like(first)

    @staticmethod
    def backward(ctx, g):
        every = all_gather_stack(g, ctx.group)
        back = every[ctx.rank - 1].clone() if ctx.rank > 0 else torch.zeros_like(g)
        return back, None, None, None


_TEMPORAL_FIELDS = ("joint_rot", "global_rot", "trans")


def temporal_losses_halo(params: FitParams, w_temp: float, group=None, size: int = 1,
                         rank: int = 0):
    """Sharded counterpart of :func:`~smilify_tpu_torch.fitter.fitter.temporal_losses`:
    per-pair MSE summed over the sequence, separately for joints / global
    rotation / trans. ``params`` holds this rank's frames, (N/D, ...), or
    a clip axis first, (S, N/D, ...), where the pairs stay within each clip.
    The pair across each rank boundary uses the next rank's first frame
    (:class:`_NextFirstFrame`, one exchange for the three fields). Every
    rank of ``group`` (of ``size`` ranks, this one ``rank``: the order of
    :func:`~smilify_tpu_torch.train.multihost.axis_group`) calls it together."""
    batched = params.trans.dim() == 3
    fields = [getattr(params, f) for f in _TEMPORAL_FIELDS]
    if not batched:
        fields = [x[None] for x in fields]
    if w_temp == 0:
        z = torch.zeros((), dtype=params.trans.dtype, device=params.trans.device)
        return z, z, z
    S = fields[0].shape[0]
    flats = [x.reshape(S, x.shape[1], -1) for x in fields]        # (S, n, d)
    nxt = [None] * 3
    if size > 1:
        first = torch.cat([f[:, 0] for f in flats], dim=-1)       # (S, Σd)
        got = _NextFirstFrame.apply(first, group, size, rank)
        nxt = list(torch.split(got, [f.shape[-1] for f in flats], dim=-1))
    not_last = 1.0 if rank < size - 1 else 0.0

    def pair_sum(flat, nxt_x):
        s = torch.zeros((), dtype=flat.dtype, device=flat.device)
        if flat.shape[1] >= 2:
            d = flat[:, 1:] - flat[:, :-1]
            s = torch.sum(torch.mean(d ** 2, dim=2))
        if nxt_x is not None:
            # the halo pair: the next rank's first frame with our last
            s = s + not_last * torch.sum(torch.mean((nxt_x - flat[:, -1]) ** 2, dim=1))
        return s * w_temp

    return tuple(pair_sum(f, n) for f, n in zip(flats, nxt))


class ShardedFitterMixin:
    """What every sharded fitter shares: the groups of its mesh, the
    shared-gradient reduction, the reported scalars' reduction (once a
    chunk) and the gathering of the parameters.

    A subclass sets ``self.mesh``, ``self._frames`` (the (group, size,
    rank) of the axis whose shared gradients are summed, None for none)
    and ``self._report_axes`` (the mesh axes the reported scalars sum over),
    and gives :meth:`_param_specs`."""

    def _param_specs(self) -> FitParams:
        """The layout of :class:`FitParams`: per field, the mesh axis each
        tensor axis is cut over (see :func:`~smilify_tpu_torch.train.multihost.globalize`)."""
        raise NotImplementedError

    def _reduce_grads(self, leaves: dict) -> None:
        group, size, _ = self._frames
        if size > 1:
            psum_shared_grads(leaves, group)

    def _reduce_report(self, t: torch.Tensor) -> torch.Tensor:
        for name in self._report_axes:
            group, size, _ = axis_group(self.mesh, name)
            if size > 1:
                all_reduce_sum(t, group)
        return t

    def _readback(self, results):
        names = list(results[0][1])
        table = torch.stack([torch.stack([r[0]] + [r[1][k] for k in names]) for r in results])
        table = self._reduce_report(table).cpu().numpy()
        return [(row[0], dict(zip(names, row[1:]))) for row in table]

    def _stage_loss(self, loss):
        return None if loss is None else self._reduce_report(loss.clone())

    def local_params(self, full: FitParams) -> FitParams:
        """This rank's block of whole-corpus or whole-sequence parameters
        (e.g. a resumed checkpoint's)."""
        return globalize(full, self.mesh, self._param_specs())

    def gathered_params(self) -> FitParams:
        """The whole corpus's or sequence's parameters on every rank, on the
        fitter's device. A collective: every rank calls it together."""
        full = allgather(self.params, self.mesh, self._param_specs())
        return FitParams(**{k: torch.from_numpy(getattr(full, k)).to(self.device)
                            for k in FitParams.fields()})


def _default_mesh(shape, names, device):
    return make_mesh(shape, names, device) if process_count() > 1 else None


class ShardedSequenceFitter(ShardedFitterMixin, SmalFitter):
    """``SmalFitter`` with the frame axis cut over a ``('frames',)`` mesh.

    Every rank is given the whole sequence (the CLIs load it on each
    process) and keeps its N/D frames; N must divide by D. ``mesh`` defaults
    to one over every rank of the process group (none in a single process:
    then it is ``SmalFitter``). ``self.params`` holds this rank's frames;
    :meth:`gathered_params` gives the whole sequence's."""

    def __init__(self, spec, data: FitData, image_size, mesh=None, device="cuda", **kwargs):
        if mesh is None:
            mesh = _default_mesh((process_count(),), ("frames",), device)
        if mesh is not None and len(mesh.mesh_dim_names) != 1:
            raise ValueError(f"need a 1-D mesh, got axes {mesh.mesh_dim_names}")
        self.mesh = mesh
        axis = mesh.mesh_dim_names[0] if mesh is not None else "frames"
        self._frames = axis_group(mesh, axis)
        self._report_axes = (axis,)
        self._axis = axis
        n_frames, D = int(data.joints.shape[0]), self._frames[1]
        if n_frames % D:
            raise ValueError(
                f"{n_frames} frames not divisible by {D} ranks — pad the sequence "
                f"(repeat trailing frames with visibility 0)")
        FRAME = (axis,)
        local = globalize(data._replace(rgb=None), mesh,
                          FitData(rgb=None, sil=FRAME, joints=FRAME, visibility=FRAME))
        super().__init__(spec, local._replace(rgb=data.rgb), image_size, device=device, **kwargs)
        self.n_local = self.n_frames
        self.n_frames = n_frames

    def _param_specs(self) -> FitParams:
        FRAME = (self._axis,)
        return FitParams(global_rot=FRAME, joint_rot=FRAME, betas=None, trans=FRAME, fov=FRAME,
                         log_beta_scales=None, joint_trans=None)

    def _total_loss(self, params, weights: StageWeights, visibility, data=None):
        """This rank's loss: its sum over the ranks, and each rank's
        gradients once the shared ones are summed, equal the unsharded
        fit's (the 1/D rule on the frame-mean terms, the halo pairs)."""
        D = self._frames[1]
        _, objs = forward_losses(
            self.spec, params, self.data if data is None else data, weights,
            self.pose_prior, self.limit_prior, self.shape_prior,
            self.image_size,
            visibility_override=visibility,
            canonical_joints=self.canonical_joints,
            allow_limb_scaling=self.allow_limb_scaling,
            use_reference=self.use_reference,
            approx_max_faces=self.approx_max_faces,
            camera=self.camera,
        )
        objs = {k: (v / D if k in _FRAME_MEAN_TERMS else v) for k, v in objs.items()}
        with monitoring.span("fit.losses"):
            tj, tg, tt = temporal_losses_halo(params, weights.w_temp, *self._frames)
        objs = dict(objs, temporal_joint=tj, temporal_global=tg, temporal_trans=tt)
        return functools.reduce(lambda a, b: a + b, objs.values()), objs

