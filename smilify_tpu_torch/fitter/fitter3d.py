"""3D mesh-registration trainer (port of ``smilify_tpu/fitter/fitter3d.py``;
the reference ``fitter_3d/trainer.py``).

Fits the SMIL template to target scan meshes via chamfer / edge / normal /
laplacian / SDF losses, in named optimization stages with per-stage parameter
groups — used to *author* new parametric models (shape spaces).

Reference behavior mirrored:
  * ``SMAL3DFitter`` params per target mesh: betas, global_rot, trans,
    per-joint log scales & translations, and free per-vertex deformations
    ``deform_verts`` (trainer.py:39-245);
  * ``SMALParamGroup.param_map`` stage schemes (trainer.py:248-291);
  * default loss weights {chamfer 1.0, edge 1.0, normal 0.01, laplacian 0.1,
    sdf 0.5} (trainer.py:26-28);
  * 3000-point surface sampling per iteration (trainer.py:376);
  * npz export of all params + verts + faces + labels (save_npz:494-508).

Differences from the JAX package, same behavior: a step is eager (``chunk``
only sets how many steps run between loss read-backs); each stage builds a
fresh ``torch.optim.Adam`` with one group at ``stage.lr``, one per
``custom_lrs`` entry, default betas (0.9, 0.999) and eps 1e-8, and the
frozen fields left out — the JAX package's ``optax.multi_transform`` of
``adam`` and ``set_to_zero``. The sampling draws come from one
``torch.Generator`` per manager, seeded from ``seed``, in step order, so the
trajectory does not depend on ``chunk``. Target meshes are padded to a common
vertex/face count with masks. :class:`ShardedStageManager` cuts the scans over
the ranks of a ``('scans',)`` mesh.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from smilify_tpu_torch._device import resolve_device
from smilify_tpu_torch.core.lbs import smil_forward
from smilify_tpu_torch.core.spec import ModelSpec
from smilify_tpu_torch.ops.gather import RowIndex
from smilify_tpu_torch.ops.mesh_ops import (
    chamfer_distance,
    edges_from_faces,
    face_adjacency_from_faces,
    laplacian_neighbors_from_faces,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
    points_from_uniforms,
    sample_uniforms,
)

# reference trainer.py:26-28
DEFAULT_LOSS_WEIGHTS = {
    "chamfer": 1.0,
    "edge": 1.0,
    "normal": 0.01,
    "laplacian": 0.1,
    "sdf": 0.5,
}

# reference SMALParamGroup.param_map (trainer.py:251-262)
PARAM_SCHEMES: Dict[str, List[str]] = {
    "init": ["global_rot", "trans"],
    "init_rot_lock": ["trans", "log_beta_scales"],
    "init_rot_lock_trans": ["trans", "betas_trans"],
    "init_rot_lock_trans_scale": ["trans", "betas_trans", "log_beta_scales"],
    "default": ["global_rot", "joint_rot", "trans", "betas", "log_beta_scales"],
    "default_with_betas_trans": [
        "global_rot", "joint_rot", "trans", "betas", "log_beta_scales", "betas_trans",
    ],
    "shape": ["global_rot", "trans", "betas", "log_beta_scales", "betas_trans"],
    "pose": ["global_rot", "trans", "joint_rot", "betas", "log_beta_scales", "betas_trans"],
    "deform": ["deform_verts"],
    "all": [
        "global_rot", "trans", "joint_rot", "betas", "log_beta_scales", "betas_trans",
        "deform_verts",
    ],
}


@dataclass
class Fit3DParams:
    """Per-target-mesh parameters (B = number of target meshes)."""

    global_rot: torch.Tensor       # (B, 3)
    joint_rot: torch.Tensor        # (B, P, 3)
    betas: torch.Tensor            # (B, n_betas)
    trans: torch.Tensor            # (B, 3)
    log_beta_scales: torch.Tensor  # (B, J, 3)
    betas_trans: torch.Tensor      # (B, J, 3)
    deform_verts: torch.Tensor     # (B, V, 3)

    @staticmethod
    def fields():
        return tuple(f.name for f in dataclasses.fields(Fit3DParams))


def fit3d_params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Fit3DParams:
    """A :class:`Fit3DParams` from one array per field — e.g. the JAX
    package's ``Fit3DParams`` carried across as ``np.asarray`` of each leaf."""
    dev = resolve_device(device)
    return Fit3DParams(**{
        k: torch.as_tensor(np.asarray(arrays[k]), dtype=torch.float32).to(dev)
        for k in Fit3DParams.fields()
    })


class TargetMeshes(NamedTuple):
    """Padded batch of target scan meshes."""

    verts: torch.Tensor       # (B, Vmax, 3)
    verts_mask: torch.Tensor  # (B, Vmax) bool
    faces: torch.Tensor       # (B, Fmax, 3) int64 (padded with 0s)
    faces_mask: torch.Tensor  # (B, Fmax) bool
    names: tuple              # mesh names


def pad_target_meshes(meshes: List[tuple], names: Optional[List[str]] = None,
                      device="cuda") -> TargetMeshes:
    """[(verts (V,3), faces (F,3)), ...] → padded TargetMeshes on ``device``."""
    dev = resolve_device(device)
    Vmax = max(v.shape[0] for v, _ in meshes)
    Fmax = max(f.shape[0] for _, f in meshes)
    B = len(meshes)
    verts = np.zeros((B, Vmax, 3), np.float32)
    vmask = np.zeros((B, Vmax), bool)
    faces = np.zeros((B, Fmax, 3), np.int64)
    fmask = np.zeros((B, Fmax), bool)
    for i, (v, f) in enumerate(meshes):
        verts[i, : v.shape[0]] = v
        vmask[i, : v.shape[0]] = True
        faces[i, : f.shape[0]] = f
        fmask[i, : f.shape[0]] = True
    return TargetMeshes(
        verts=torch.from_numpy(verts).to(dev),
        verts_mask=torch.from_numpy(vmask).to(dev),
        faces=torch.from_numpy(faces).to(dev),
        faces_mask=torch.from_numpy(fmask).to(dev),
        names=tuple(names or [f"mesh_{i}" for i in range(B)]),
    )


def init_3d_params(spec: ModelSpec, batch_size: int,
                   mean_betas: Optional[np.ndarray] = None) -> Fit3DParams:
    dev = spec.device
    mb = (torch.as_tensor(np.asarray(mean_betas), dtype=torch.float32).to(dev)
          if mean_betas is not None else spec.shape_mean_betas)
    return Fit3DParams(
        global_rot=torch.zeros((batch_size, 3), device=dev),
        joint_rot=torch.zeros((batch_size, spec.n_joints - 1, 3), device=dev),
        betas=mb[None].repeat(batch_size, 1),
        trans=torch.zeros((batch_size, 3), device=dev),
        log_beta_scales=torch.zeros((batch_size, spec.n_joints, 3), device=dev),
        betas_trans=torch.zeros((batch_size, spec.n_joints, 3), device=dev),
        deform_verts=torch.zeros((batch_size, spec.n_verts, 3), device=dev),
    )


def fitter3d_forward(spec: ModelSpec, params: Fit3DParams, propagate_scaling: bool = True):
    """Current deformed template mesh batch: (B, V, 3) verts + joints."""
    theta = torch.cat([params.global_rot[:, None, :], params.joint_rot], dim=1)
    out = smil_forward(
        spec,
        params.betas,
        theta,
        trans=params.trans,
        del_v=params.deform_verts,
        log_scales=params.log_beta_scales,
        joint_trans=params.betas_trans,
        propagate_scaling=propagate_scaling,
    )
    return out.verts, out.joints


class MeshTopology(NamedTuple):
    """Host-precomputed SMIL template topology for the regularizers and the
    template's sampling: each index with its inverse table (``RowIndex``),
    so that every fixed-topology gather's backward is a gather and a sum in
    a fixed order."""

    edges: RowIndex       # (E, 2)
    nbr_table: RowIndex   # (V, max_degree), padding left out of the inverse
    nbr_degree: torch.Tensor
    adjacency: RowIndex   # (P, 4)
    faces: RowIndex       # (F, 3)


def template_topology(spec: ModelSpec) -> MeshTopology:
    faces = spec.faces.cpu().numpy()
    V, dev = spec.n_verts, spec.device
    table, deg = laplacian_neighbors_from_faces(faces, V)
    padding = np.arange(table.shape[1])[None, :] >= deg[:, None]
    return MeshTopology(
        edges=RowIndex.build(edges_from_faces(faces), V, device=dev),
        nbr_table=RowIndex.build(table, V, valid=~padding, device=dev),
        nbr_degree=torch.as_tensor(deg, dtype=torch.int64).to(dev),
        adjacency=RowIndex.build(face_adjacency_from_faces(faces), V, device=dev),
        faces=RowIndex.build(faces, V, device=dev))


def registration_uniforms(batch: int, num_samples: int,
                          generator: Optional[torch.Generator] = None, device="cpu"):
    """The draws of one :func:`registration_losses` step: for each of the
    ``batch`` meshes, the uniforms (``sample_uniforms``) of the template's and
    of the target's samples — ``(r_src, u_src, r_tgt, u_tgt)``, (B, S) and
    (B, S, 2)."""
    r_src, u_src = sample_uniforms(num_samples, generator, device, (batch,))
    r_tgt, u_tgt = sample_uniforms(num_samples, generator, device, (batch,))
    return r_src, u_src, r_tgt, u_tgt


def registration_losses(
    spec: ModelSpec,
    topo: MeshTopology,
    params: Fit3DParams,
    targets: TargetMeshes,
    generator: Optional[torch.Generator],
    loss_weights: Dict[str, float],
    num_samples: int = 3000,
    target_sdf: Optional[torch.Tensor] = None,
    src_sdf: Optional[torch.Tensor] = None,
    uniforms=None,
):
    """Weighted loss dict over the mesh batch (reference Stage.loss,
    trainer.py:371-435). The samples' uniforms are drawn from ``generator``
    (:func:`registration_uniforms`) unless ``uniforms`` gives them."""
    verts, _ = fitter3d_forward(spec, params)
    B = verts.shape[0]

    def on(name):
        return loss_weights.get(name, 0.0) > 0

    objs = {}
    if on("chamfer") or on("sdf"):
        if uniforms is None:
            uniforms = registration_uniforms(B, num_samples, generator, verts.device)
        r_src, u_src, r_tgt, u_tgt = uniforms
        src_pts = points_from_uniforms(verts, topo.faces, r_src, u_src)
        # faces_mask zeroes padded faces' sampling weight explicitly —
        # independent of the padding also being (0,0,0) degenerate
        tgt_pts = points_from_uniforms(targets.verts, targets.faces, r_tgt, u_tgt,
                                       face_mask=targets.faces_mask)

    # every mesh has the template's edges, faces and vertices, so each mean
    # over the batch of per-mesh means is one mean over the batch
    if on("chamfer"):
        objs["chamfer"] = loss_weights["chamfer"] * chamfer_distance(src_pts, tgt_pts)
    if on("edge"):
        objs["edge"] = loss_weights["edge"] * mesh_edge_loss(verts, topo.edges)
    if on("normal"):
        objs["normal"] = loss_weights["normal"] * mesh_normal_consistency(verts, topo.adjacency)
    if on("laplacian"):
        objs["laplacian"] = loss_weights["laplacian"] * mesh_laplacian_smoothing(
            verts, topo.nbr_table, topo.nbr_degree)
    if on("sdf") and target_sdf is not None and src_sdf is not None:
        from smilify_tpu_torch.ops.sdf import sdf_distance

        objs["sdf"] = loss_weights["sdf"] * torch.mean(
            sdf_distance(src_pts, tgt_pts, src_sdf, target_sdf))

    total = sum(objs.values())
    return total, objs


class Stage:
    """A named optimization stage (reference trainer.py:294-508)."""

    def __init__(
        self,
        name: str,
        scheme: str,
        n_its: int,
        lr: float = 1e-3,
        loss_weights: Optional[Dict[str, float]] = None,
        custom_lrs: Optional[Dict[str, float]] = None,
        num_samples: int = 3000,
    ):
        self.name = name
        self.scheme = scheme
        self.n_its = n_its
        self.lr = lr
        self.loss_weights = dict(DEFAULT_LOSS_WEIGHTS, **(loss_weights or {}))
        self.custom_lrs = custom_lrs or {}
        self.num_samples = num_samples
        self.loss_history: List[Dict[str, float]] = []


class StageManager:
    """Runs stages sequentially over the padded target-mesh batch (on the
    spec's device; ``targets`` must be there too)."""

    def __init__(self, spec: ModelSpec, targets: TargetMeshes,
                 params: Optional[Fit3DParams] = None, seed: int = 0,
                 propagate_scaling: bool = True):
        self.spec = spec
        self.targets = targets
        self.topo = template_topology(spec)
        self.params = params or init_3d_params(spec, targets.verts.shape[0])
        self.generator = torch.Generator(device=spec.device).manual_seed(seed)
        self.stages: List[Stage] = []
        self.propagate_scaling = propagate_scaling

    def add_stage(self, stage: Stage):
        self.stages.append(stage)

    def _optimizer(self, stage: Stage, leaves: Dict[str, torch.Tensor]):
        """Fresh per-stage Adam: trainable fields in the ``stage.lr`` group or
        in their own ``custom_lrs`` group; frozen fields are left out."""
        main = [v for k, v in leaves.items() if k not in stage.custom_lrs]
        groups = [{"params": main, "lr": stage.lr}] if main else []
        groups += [{"params": [leaves[k]], "lr": lr}
                   for k, lr in stage.custom_lrs.items() if k in leaves]
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)

    def run(self, callback=None, chunk: int = 1):
        """Run all stages. ``chunk`` steps run back to back between loss
        read-backs (per-iteration loss history and callbacks are kept)."""
        for stage in self.stages:
            trainable = PARAM_SCHEMES[stage.scheme]
            leaves = {k: getattr(self.params, k).detach().clone().requires_grad_(True)
                      for k in Fit3DParams.fields() if k in trainable}
            params = Fit3DParams(**{k: leaves.get(k, getattr(self.params, k))
                                    for k in Fit3DParams.fields()})
            opt = self._optimizer(stage, leaves)
            lw = dict(stage.loss_weights)

            def step():
                opt.zero_grad(set_to_none=True)
                total, objs = self._losses(params, lw, stage.num_samples)
                total.backward()
                with torch.no_grad():
                    for leaf in leaves.values():
                        if leaf.grad is None:   # optax's adam steps it all the same
                            leaf.grad = torch.zeros_like(leaf)
                opt.step()
                return total.detach(), {k: v.detach() for k, v in objs.items()}

            c = max(1, min(int(chunk), stage.n_its or 1))
            it = 0
            while it < stage.n_its:
                n = min(c, stage.n_its - it)
                results = [step() for _ in range(n)]
                names = list(results[0][1])
                # ONE device→host read-back per chunk
                table = self._reduce_report(torch.stack([
                    torch.stack([r[0]] + [r[1][k] for k in names]) for r in results])).cpu().numpy()
                for j, row in enumerate(table):
                    objs_j = {k: float(v) for k, v in zip(names, row[1:])}
                    stage.loss_history.append(objs_j)
                    if callback:
                        callback(stage.name, it + j, float(row[0]), objs_j)
                it += n
            self.params = Fit3DParams(**{k: getattr(params, k).detach()
                                         for k in Fit3DParams.fields()})
        return self.params

    def _losses(self, params: Fit3DParams, lw: Dict[str, float], num_samples: int):
        """One step's (total, weighted terms) over the manager's meshes."""
        return registration_losses(self.spec, self.topo, params, self.targets,
                                   self.generator, lw, num_samples)

    def _reduce_report(self, table: torch.Tensor) -> torch.Tensor:
        """A chunk's reported (loss, terms) rows: as they are on one device."""
        return table

    def plot_losses(self, out_dir: str, name: str = "losses"):
        """Semilog total-loss curve across all stages on one axis
        (reference StageManager.plot_losses, trainer.py:529-547), 640×480."""
        from smilify_tpu_torch.utils import plotting

        os.makedirs(out_dir, exist_ok=True)
        fig, ax = plotting.subplots()
        it0 = 0
        for stage in self.stages:
            totals = [sum(h.values()) for h in stage.loss_history]
            if totals:
                ax.semilogy(np.arange(it0, it0 + len(totals)), totals, label=stage.name)
            it0 += len(totals)
        ax.set_xlabel("iteration")
        ax.set_ylabel("total loss")
        ax.legend()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path)
        return path

    def plot_loss_components(self, out_dir: str, name: str = "loss_components"):
        """Per-component semilog subplots across stages (reference
        StageManager.plot_loss_components, trainer.py:549-583), 800 × 300
        pixels a component."""
        from smilify_tpu_torch.utils import plotting

        os.makedirs(out_dir, exist_ok=True)
        components = sorted({k for s in self.stages for h in s.loss_history for k in h})
        if not components:
            return None
        fig, axes = plotting.subplots(len(components), 1,
                                      figsize=(8, 3 * len(components)), squeeze=False)
        for i, comp in enumerate(components):
            ax = axes[i][0]
            it0 = 0
            for stage in self.stages:
                vals = [h[comp] for h in stage.loss_history if comp in h]
                if vals:
                    ax.semilogy(np.arange(it0, it0 + len(vals)), vals, label=stage.name)
                it0 += len(stage.loss_history)
            ax.set_title(comp)
            ax.legend()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path)
        return path

    @torch.no_grad()
    def save_npz(self, out_dir: str, stage_name: str = "final"):
        """Export all params + verts + faces + labels (reference save_npz,
        trainer.py:494-508)."""
        return self._write_npz(out_dir, stage_name, self.params, self.targets.names)

    def _write_npz(self, out_dir: str, stage_name: str, params: Fit3DParams, names) -> str:
        os.makedirs(out_dir, exist_ok=True)
        verts, joints = fitter3d_forward(self.spec, params, self.propagate_scaling)
        path = os.path.join(out_dir, f"{stage_name}.npz")

        def host(x):
            return x.detach().cpu().numpy()

        np.savez(
            path,
            **{k: host(getattr(params, k)) for k in Fit3DParams.fields()},
            verts=host(verts),
            joints=host(joints),
            faces=host(self.spec.faces).astype(np.int32),
            labels=np.asarray(names),
        )
        return path


class ShardedStageManager(StageManager):
    """:class:`StageManager` with the scans cut over the ranks of a 1-D
    ``('scans',)`` mesh: a scan library registered across several cards.

    Every :class:`Fit3DParams` field is per scan (scans share nothing), so
    the step needs NO collective in the optimization: each rank registers
    its B/D scans, and only the reported scalars are summed. Each term is a
    mean over the scan batch, so each rank scales its terms by 1/D: their
    sum over the ranks, and every local gradient, equal the unsharded ones.
    The samples: every rank draws the WHOLE batch's uniforms from the same
    seeded generator, in the unsharded manager's order, and keeps its rows,
    so each rank samples exactly what the unsharded run samples for its
    scans. Every rank is given the whole batch (targets and, if any, initial
    parameters) and keeps its block; ``mesh`` defaults to every rank."""

    def __init__(self, spec: ModelSpec, targets: TargetMeshes,
                 params: Optional[Fit3DParams] = None, seed: int = 0,
                 propagate_scaling: bool = True, mesh=None):
        from smilify_tpu_torch.train.multihost import axis_group, globalize, make_mesh, process_count

        if mesh is None and process_count() > 1:
            mesh = make_mesh((process_count(),), ("scans",), spec.device)
        if mesh is not None and len(mesh.mesh_dim_names) != 1:
            raise ValueError(f"need a 1-D mesh, got axes {mesh.mesh_dim_names}")
        self.mesh = mesh
        self._axis = mesh.mesh_dim_names[0] if mesh is not None else "scans"
        self._group = axis_group(mesh, self._axis)
        self.n_scans = B = int(targets.verts.shape[0])
        D, r = self._group[1], self._group[2]
        if B % D:
            raise ValueError(f"{B} scans not divisible by {D} ranks — pad the batch "
                             f"(duplicate scans; drop the duplicates from the exported npz)")
        self._rows = slice(r * (B // D), (r + 1) * (B // D))
        self.all_names = tuple(targets.names)
        SCAN = (self._axis,)
        local = globalize(targets._replace(names=None), mesh,
                          TargetMeshes(SCAN, SCAN, SCAN, SCAN, None))
        if params is not None:
            params = globalize(params, mesh, Fit3DParams(*[SCAN] * len(Fit3DParams.fields())))
        super().__init__(spec, local._replace(names=self.all_names[self._rows]), params=params,
                         seed=seed, propagate_scaling=propagate_scaling)

    def _losses(self, params: Fit3DParams, lw: Dict[str, float], num_samples: int):
        uniforms = None
        if lw.get("chamfer", 0.0) > 0 or lw.get("sdf", 0.0) > 0:
            # the unsharded batch's draws, this rank's rows of them
            every = registration_uniforms(self.n_scans, num_samples, self.generator,
                                          self.spec.device)
            uniforms = tuple(u[self._rows] for u in every)
        _, objs = registration_losses(self.spec, self.topo, params, self.targets, None, lw,
                                      num_samples, uniforms=uniforms)
        D = self._group[1]
        objs = {k: v / D for k, v in objs.items()}
        return sum(objs.values()), objs

    def _reduce_report(self, table: torch.Tensor) -> torch.Tensor:
        from smilify_tpu_torch.train.multihost import all_reduce_sum

        group, size, _ = self._group
        return all_reduce_sum(table, group) if size > 1 else table

    def gathered_params(self) -> Fit3DParams:
        """Every scan's parameters on every rank (a collective)."""
        from smilify_tpu_torch.train.multihost import allgather

        SCAN = (self._axis,)
        full = allgather(self.params, self.mesh, Fit3DParams(*[SCAN] * len(Fit3DParams.fields())))
        return Fit3DParams(**{k: torch.from_numpy(getattr(full, k)).to(self.spec.device)
                              for k in Fit3DParams.fields()})

    def save_npz(self, out_dir: str, stage_name: str = "final", keep: Optional[int] = None):
        """:meth:`StageManager.save_npz` of the first ``keep`` scans (default
        all; the rest is padding), written by process 0. A collective: every
        rank calls it; the others return None."""
        from smilify_tpu_torch.train.multihost import is_primary

        keep = self.n_scans if keep is None else keep
        params = self.gathered_params()
        if not is_primary():
            return None
        with torch.no_grad():
            return self._write_npz(out_dir, stage_name, Fit3DParams(
                **{k: getattr(params, k)[:keep] for k in Fit3DParams.fields()}),
                self.all_names[:keep])
