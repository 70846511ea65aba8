"""Handing the benchmark's inputs to the program under test
(``smilify_tpu_torch``): its model spec from the mesh's arrays, its
single-view regressor with the seeded weights loaded by name."""

from __future__ import annotations

import torch


def spec(mesh_np: dict, device):
    from smilify_tpu_torch.core.spec import spec_from_numpy

    names = tuple(f"j{i}" for i in range(mesh_np["parents"].shape[0]))
    return spec_from_numpy(mesh_np, device=device, joint_names=names,
                           static_joint_locations=False, has_shape_prior=True,
                           legacy_dog_keypoints=False, root_joint=names[0], torso_joints=(0, 1),
                           source_path="<portbench>")


def regressor(cfg: dict, weights: dict, device):
    """(RegressorConfig, SMILRegressor) at the configuration's widths, its
    backbone under bf16 autocast, on ``device`` (channels_last on a card)
    with every tensor of ``weights`` loaded (strictly, by name)."""
    from smilify_tpu_torch.models.regressor import RegressorConfig, SMILRegressor

    J, B, h = cfg["model"]["J"], cfg["model"]["B"], cfg["head"]
    rcfg = RegressorConfig(n_pose=J - 1, n_betas=B, n_joints=J, backbone=cfg["backbone"],
                           decoder_dim=h["dim"], decoder_depth=h["depth"],
                           decoder_heads=h["heads"], ief_iters=h["iters"],
                           compute_dtype=getattr(torch, cfg["backbone_dtype"]))
    with torch.device(device):
        model = SMILRegressor(rcfg, img_size=cfg["image_size"])
    model.load_state_dict(weights, strict=True)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return rcfg, model
