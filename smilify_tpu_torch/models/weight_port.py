"""Carrying weights into the port's regressors (port of
``smilify_tpu/models/weight_port.py``).

Two sources:

* **The JAX package's parameters.** :func:`state_dict_from_flax` turns a
  Flax ``{"params": ..., "batch_stats": ...}`` tree (nested dicts of numpy
  arrays, as ``jax.device_get`` or orbax return it) into the ``state_dict``
  of a port model built from the same config. It walks the port's modules
  with their :meth:`flax_names` (identity where a module has none), converts
  each leaf (conv kernels HWIO → OIHW, depthwise included; Dense (in, out) →
  (out, in); attention query/key/value (D, H, Dh) → (H·Dh, D) and out
  (H, Dh, D) → (D, H·Dh); BatchNorm mean/var → running_mean/running_var;
  Embed, ``init_estimate``, ``cls_token``, ``pos_embed``, ``gamma`` as they
  are) and is strict: a port key left unfilled, a Flax leaf left unused or
  a shape that differs raises ``ValueError``.
* **torchvision/timm dumps.** ``python -m smilify_tpu_torch.models.weight_port
  dump --arch resnet50 --out r50.npz`` (on a machine with torchvision or
  timm) writes a state dict to ``.npz``; :func:`load_pretrained_npz` loads it
  into the backbone by state-dict name (the port's backbones carry those
  names), or for the ``unet_*`` backbones into their ``encoder``.
  :func:`apply_pretrained_policy` is the trainers' policy around it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from smilify_tpu_torch.models.backbones import UNET_ENCODER_BACKBONES


def _flax_leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flax_leaves(v, prefix + (k,))
    else:
        yield prefix


def _children(module: nn.Module) -> Dict[str, str]:
    """{torch name: Flax name} of a module's direct children and parameters."""
    if hasattr(module, "flax_names"):
        return module.flax_names()
    names = {n: n for n, _ in module.named_children()}
    names.update({n: n for n, _ in module.named_parameters(recurse=False)})
    return names


class _Walk:
    def __init__(self, params, batch_stats):
        self.params, self.stats = params, batch_stats or {}
        self.out: Dict[str, torch.Tensor] = {}
        self.used = set()

    def get(self, coll, path):
        tree = self.params if coll == "params" else self.stats
        for p in path:
            if not isinstance(tree, Mapping) or p not in tree:
                raise ValueError(f"no Flax {coll} leaf {'/'.join(path)}")
            tree = tree[p]
        if isinstance(tree, Mapping):
            raise ValueError(f"Flax {coll} {'/'.join(path)} is a subtree, not a leaf")
        self.used.add((coll,) + tuple(path))
        return torch.as_tensor(np.asarray(tree, dtype=np.float32))

    def put(self, key, value):
        self.out[key] = value

    def module(self, m: nn.Module, prefix: str, path: tuple):
        p = prefix
        if hasattr(m, "load_flax"):
            sub = self.params
            for k in path:
                sub = sub[k]
            for leaf in _flax_leaves(sub):
                self.used.add(("params",) + path + leaf)
            for k, v in m.load_flax(sub).items():
                self.put(p + k, v)
        elif isinstance(m, nn.Conv2d):
            self.put(p + "weight", self.get("params", path + ("kernel",)).permute(3, 2, 0, 1))
            if m.bias is not None:
                self.put(p + "bias", self.get("params", path + ("bias",)))
        elif isinstance(m, nn.Linear):
            k = self.get("params", path + ("kernel",))
            if k.numel() != m.in_features * m.out_features:
                raise ValueError(f"state_dict_from_flax: {'/'.join(path)} kernel {tuple(k.shape)} "
                                 f"for a ({m.in_features} → {m.out_features}) layer")
            self.put(p + "weight", k.reshape(m.in_features, m.out_features).T)
            if m.bias is not None:
                self.put(p + "bias", self.get("params", path + ("bias",)).reshape(-1))
        elif isinstance(m, nn.BatchNorm2d):
            self.put(p + "weight", self.get("params", path + ("scale",)))
            self.put(p + "bias", self.get("params", path + ("bias",)))
            self.put(p + "running_mean", self.get("batch_stats", path + ("mean",)))
            self.put(p + "running_var", self.get("batch_stats", path + ("var",)))
            self.put(p + "num_batches_tracked", torch.zeros((), dtype=torch.long))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            self.put(p + "weight", self.get("params", path + ("scale",)))
            self.put(p + "bias", self.get("params", path + ("bias",)))
        elif isinstance(m, nn.Embedding):
            self.put(p + "weight", self.get("params", path + ("embedding",)))
        else:
            for tname, fname in _children(m).items():
                try:
                    child = m.get_submodule(tname)
                except AttributeError:
                    self.put(p + tname, self.get("params", path + (fname,)))
                    continue
                self.module(child, p + tname + ".", path + (fname,))


def build_model(cfg, img_size: int = 224) -> nn.Module:
    """The port's regressor for a ``RegressorConfig`` or ``MultiViewConfig``."""
    from smilify_tpu_torch.models.multiview import MultiViewConfig, MultiViewSMILRegressor
    from smilify_tpu_torch.models.regressor import SMILRegressor

    if isinstance(cfg, MultiViewConfig):
        return MultiViewSMILRegressor(cfg, img_size=img_size)
    return SMILRegressor(cfg, img_size=img_size)


def state_dict_from_flax(variables, model, img_size: int = 224) -> Dict[str, torch.Tensor]:
    """The state dict of the port's ``model`` (a module, or a regressor
    config from which :func:`build_model` builds one at ``img_size``) from
    the JAX package's variables of the same architecture (``{"params": ...,
    "batch_stats": ...}``). Strict: raises ``ValueError`` on a missing or
    extra leaf or a shape mismatch."""
    if not isinstance(model, nn.Module):
        model = build_model(model, img_size)
    params = variables["params"]
    stats = variables.get("batch_stats", {}) or {}
    walk = _Walk(params, stats)
    walk.module(model, "", ())
    want = model.state_dict()
    missing = sorted(set(want) - set(walk.out))
    extra = sorted(set(walk.out) - set(want))
    if missing or extra:
        raise ValueError(f"state_dict_from_flax: port keys not filled {missing[:8]}, "
                         f"keys the model lacks {extra[:8]}")
    for k, v in walk.out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"state_dict_from_flax: {k} has shape {tuple(v.shape)} from Flax, "
                             f"{tuple(want[k].shape)} in the model")
    leaves = {("params",) + p for p in _flax_leaves(params)}
    leaves |= {("batch_stats",) + p for p in _flax_leaves(stats)}
    unused = sorted("/".join(p) for p in leaves - walk.used)
    if unused:
        raise ValueError(f"state_dict_from_flax: Flax leaves not used {unused[:8]}")
    return {k: v.to(want[k].dtype) for k, v in walk.out.items()}


def load_pretrained_npz(model: nn.Module, npz_path: str, backbone_name: str) -> None:
    """Load a torchvision/timm state-dict dump into ``model.backbone`` by
    name: ``resnet*`` and ``vit*`` into the backbone, the ``unet_*``
    encoder backbones into its ``encoder`` (their decoder keeps its fresh
    init). Every key of the target must be in the dump with its shape; a
    ViT dump made at another resolution (``pos_embed``) is refused."""
    if backbone_name.startswith(("resnet", "vit")):
        target = model.backbone
    elif backbone_name in UNET_ENCODER_BACKBONES:
        target = model.backbone.encoder
    else:
        raise ValueError(
            f"no torch weight source exists for backbone '{backbone_name}' — the "
            "hand-rolled UNet variants (unet_small/unet_mid/unet_micro) train from scratch; "
            "the unet_* ported-encoder variants take torchvision resnet34/resnet50 or timm "
            "efficientnet_b0/b3/b5 / mobilenetv3_large_100 / convnext_base dumps")
    with np.load(npz_path) as z:
        sd = {k: torch.as_tensor(z[k]) for k in z.files}
    want = target.state_dict()
    missing = sorted(k for k in want if k not in sd and not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(f"{npz_path} lacks {len(missing)} of the backbone's keys, e.g. {missing[:5]}")
    for k in want:
        if k in sd and tuple(sd[k].shape) != tuple(want[k].shape):
            raise ValueError(f"ported weight shape mismatch at '{k}': checkpoint "
                             f"{tuple(sd[k].shape)} vs model {tuple(want[k].shape)}"
                             + (" (a different input resolution)" if k == "pos_embed" else ""))
    target.load_state_dict({k: sd[k] if k in sd else want[k] for k in want})


def apply_pretrained_policy(cfg, model: nn.Module, allow_random_backbone: bool = False) -> None:
    """Load ``model.pretrained_npz`` when set; otherwise refuse to train a
    frozen random backbone unless allowed."""
    if cfg.model.pretrained_npz:
        load_pretrained_npz(model, cfg.model.pretrained_npz, cfg.model.backbone_name)
        print(f"loaded pretrained backbone weights from {cfg.model.pretrained_npz}")
    elif cfg.model.freeze_backbone and cfg.model.backbone_unfreeze_epoch is None \
            and not allow_random_backbone:
        raise SystemExit(
            "model.freeze_backbone=true with no model.pretrained_npz would train a frozen "
            "RANDOM encoder. Set model.pretrained_npz (see "
            "smilify_tpu_torch/models/weight_port.py), set freeze_backbone=false, or pass "
            "--allow-random-backbone.")


def _dump_cli(argv=None):
    """Dump a torchvision/timm state dict to npz (run where those exist)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["dump"])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.arch.startswith("resnet"):
        import torchvision.models as tvm

        model = getattr(tvm, args.arch)(weights="IMAGENET1K_V2")
    else:
        import timm

        model = timm.create_model(args.arch, pretrained=True)
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(args.out, **sd)
    print(f"dumped {len(sd)} tensors → {args.out}")


if __name__ == "__main__":
    _dump_cli()
