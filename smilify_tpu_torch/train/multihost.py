"""Multi-process launch wiring and collectives (port of
``smilify_tpu/train/multihost.py``) on ``torch.distributed``.

The JAX package calls ``jax.distributed.initialize()`` and lets XLA insert
the collectives of a sharded program. Here every rank is a process (one a
card, launched by ``torchrun`` or SLURM), and the collectives are explicit
calls on the process groups of a :class:`torch.distributed.device_mesh.DeviceMesh`
whose axes carry the JAX meshes' names: ``("frames",)``, ``("clips",)``,
``("clips", "frames")``, ``("scans",)`` and ``("data",)``. What stays as in
JAX:

  * deciding WHEN to initialize (an explicit ``--multihost`` flag, or the
    launcher's environment: :func:`detect_multihost_env`);
  * host-side side effects (checkpoints, plots, exports) on process 0 only;
  * global-batch math: each process feeds its share of the global batch.

The backend follows the device, chosen explicitly: ``nccl`` for ``cuda``,
``gloo`` for ``cpu``. NCCL refuses two ranks on one card, so a multi-rank
run on one card passes ``backend="gloo"``: gloo reduces and broadcasts
CUDA tensors itself, and every other collective here goes through a host
copy (:func:`all_gather_stack`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def detect_multihost_env(environ=None) -> bool:
    """True when the environment says this process is one of several
    (the reference's ``is_distributed_launch``, train_multiview_regressor.py:114-128).

    A worker id alone is not enough: single-host TPU VMs set
    ``TPU_WORKER_ID=0`` and every ``srun`` job sets ``SLURM_PROCID``. A
    world of more than one process (torchrun's ``WORLD_SIZE`` with its
    ``MASTER_ADDR``, SLURM's task count, a pod's host list) or
    ``SMILIFY_MULTIHOST=1`` must say so too."""
    env = os.environ if environ is None else environ

    def _int(name):
        try:
            return int(env.get(name, ""))
        except ValueError:
            return 0

    if env.get("SMILIFY_MULTIHOST", "").lower() in ("1", "true", "yes"):
        return True
    if "MASTER_ADDR" in env and _int("WORLD_SIZE") > 1:
        return True   # torchrun's rendezvous: unambiguous
    if "SLURM_PROCID" in env and _int("SLURM_NTASKS") > 1:
        return True
    if "TPU_WORKER_ID" in env or "CLOUD_TPU_TASK_ID" in env:
        hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
        return len(hosts) > 1
    return False


def default_backend(device) -> str:
    """The backend for ``device``: ``nccl`` for a card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_multihost(flag: bool = False, environ=None, device="cuda",
                               backend: Optional[str] = None) -> bool:
    """``init_process_group`` when the flag or the environment asks for it.

    Rank and world size come from torchrun's ``RANK``/``WORLD_SIZE`` (or
    SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID``), the
    rendezvous from ``MASTER_ADDR``/``MASTER_PORT``. ``backend`` defaults to
    :func:`default_backend` of ``device``; on a card the process's current
    device becomes :func:`rank_device`'s. Returns True when the group is up
    (a second call is a no-op)."""
    from smilify_tpu_torch._device import resolve_device

    env = os.environ if environ is None else environ
    if not (flag or detect_multihost_env(env)):
        return False
    device = resolve_device(device)
    if dist.is_initialized():
        return True
    for ours, slurm in (("RANK", "SLURM_PROCID"), ("WORLD_SIZE", "SLURM_NTASKS"),
                        ("LOCAL_RANK", "SLURM_LOCALID")):
        if ours not in env and slurm in env:
            os.environ[ours] = env[slurm]
    backend = backend or default_backend(device)
    dev = rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()} on {dev} "
          f"({backend})")
    return True


def rank_device(device="cuda", backend: Optional[str] = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a card (``cuda:0``
    without a launcher), ``device`` otherwise. Ranks beyond the visible
    cards share them only under gloo, which is chosen explicitly; NCCL
    refuses two ranks on one card, so that raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local < n:
        return torch.device("cuda", local)
    backend = backend or (dist.get_backend() if dist.is_initialized() else "nccl")
    if backend != "gloo":
        raise RuntimeError(f"LOCAL_RANK {local} has no card of its own ({n} visible); "
                           f"ranks may share a card only with backend='gloo'")
    return torch.device("cuda", local % n)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on process 0: the only process that writes checkpoints, plots
    and visualizations (the reference's ``rank == 0`` gating,
    train_multiview_regressor.py:2661-2745)."""
    return process_index() == 0


def local_batch_size(global_batch_size: int, process_count_: Optional[int] = None) -> int:
    """Each process's share of the global batch: every process feeds the
    same number of samples a step; the global batch is rounded down to a
    multiple of the process count, at least one a process."""
    n = process_count_ if process_count_ is not None else process_count()
    return max(1, global_batch_size // n)


def shard_dataset_for_process(dataset, global_batch_size: int):
    """``DistributedSampler`` semantics for a map-style dataset: the local
    batch size and a strided shard of the dataset, wrap-padded to the SAME
    length on every process (an uneven split would give one process an
    extra batch whose collective step the others never enter; the
    reference's DistributedSampler pads by repeating from the start,
    train_multiview_regressor.py:2415-2426). Returns ``(local_batch_size,
    local_dataset)``."""
    from smilify_tpu_torch.train.trainer import SubsetDataset

    bs = local_batch_size(global_batch_size)
    pi, pc = process_index(), process_count()
    local_idx = np.arange(pi, len(dataset), pc)
    per_host = -(-len(dataset) // pc)
    if 0 < len(local_idx) < per_host:
        local_idx = np.concatenate([local_idx, local_idx[: per_host - len(local_idx)]])
    local = SubsetDataset(dataset, local_idx)
    print(f"multihost: host {pi}/{pc}, local batch {bs}, {len(local)} local train samples")
    return bs, local


def primary_only(fn):
    """Decorator: run ``fn`` on process 0 only, return None elsewhere."""

    def wrapped(*a, **kw):
        if not is_primary():
            return None
        return fn(*a, **kw)

    wrapped.__name__ = getattr(fn, "__name__", "primary_only")
    wrapped.__doc__ = fn.__doc__
    return wrapped


# ---------------------------------------------------------------------------
# meshes and layouts
# ---------------------------------------------------------------------------


def make_mesh(shape: Sequence[int], names: Sequence[str], device="cuda"):
    """A :class:`DeviceMesh` of ``shape`` over the world's ranks with the
    JAX mesh's axis names (the world group must be up and as large)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        # the current device is set first, so the mesh keeps it (ranks
        # sharing a card under gloo included)
        torch.zeros((), device=dev)
    return init_device_mesh(dev.type, tuple(int(s) for s in shape), mesh_dim_names=tuple(names))


def axis_group(mesh, name: str):
    """(group, size, this rank's index) of one mesh axis; (None, 1, 0)
    without a mesh."""
    if mesh is None:
        return None, 1, 0
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


def _slice(x, mesh, spec):
    """``x``'s block on this rank: axis i of ``x`` cut over mesh axis
    ``spec[i]`` (None: whole)."""
    for axis, name in enumerate(spec):
        if name is None:
            continue
        _, n, r = axis_group(mesh, name)
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"axis {axis} of size {size} not divisible by the {n} ranks of {name!r}")
        step = size // n
        x = (x.narrow(axis, r * step, step) if isinstance(x, torch.Tensor)
             else np.take(x, np.arange(r * step, (r + 1) * step), axis=axis))
    return x


def _map_layout(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, NamedTuples and dataclasses
    whose leaves are arrays; ``specs`` mirrors it with one tuple of mesh
    axis names (or None) a leaf, or is None for the whole tree. None leaves
    stay None."""
    if tree is None:
        return None

    def sub(get):
        return None if specs is None else get(specs)

    if isinstance(tree, dict):
        return {k: _map_layout(fn, v, sub(lambda s: s[k])) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_layout(fn, v, sub(lambda s: s[i])) for i, v in enumerate(tree)))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _map_layout(fn, getattr(tree, f.name),
                                                 sub(lambda s: getattr(s, f.name)))
                             for f in dataclasses.fields(tree)})
    return fn(tree, specs)


def globalize(tree, mesh, specs):
    """Each rank keeps its block of the full per-host copy ``tree`` (every
    CLI loads the whole corpus on each process). ``specs`` mirrors ``tree``
    (see :func:`_map_layout`); a None spec keeps a leaf whole."""
    return _map_layout(lambda x, s: x if s is None else _slice(x, mesh, s), tree, specs)


def host_group(group):
    """A gloo group over ``group``'s ranks for flags kept on the host: the
    group itself when it is gloo, else a new one (every rank of the world
    calls this together). Agreeing on a host flag over NCCL would wait for
    the card's queued work first."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(ranks=dist.get_process_group_ranks(group), backend="gloo")


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_stack(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked on a new leading axis in rank
    order, on ``t``'s device. Under gloo a card's tensor goes through a host
    copy (gloo gathers host tensors)."""
    src = t.detach()
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device) if host else torch.stack(out)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group``, in place (gloo and NCCL both reduce a
    card's tensors themselves)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather_axis(x: torch.Tensor, mesh, name: str, axis: int) -> torch.Tensor:
    group, n, _ = axis_group(mesh, name)
    if n == 1:
        return x
    return torch.cat(all_gather_stack(x, group).unbind(0), dim=axis)


def allgather(tree, mesh=None, specs=None):
    """The full value of ``tree`` (laid out by ``specs`` as in
    :func:`globalize`) as host numpy on EVERY process. A collective: every
    process calls it together; gate only the write that follows to process
    0. Without a mesh: a plain copy to the host."""

    def gather(x, spec):
        for axis, name in enumerate(spec or ()):
            if name is not None and mesh is not None:
                x = _gather_axis(x, mesh, name, axis)
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return _map_layout(gather, tree, specs)


class AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the same sum of the incoming
    gradients: every rank's loss reaches the inputs of every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        all_reduce_sum(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_sum(g, ctx.group)
        return g, None
