"""The port's weight carrying (``smilify_tpu_torch/models/weight_port.py``).

* ``state_dict_from_flax`` is strict: a Flax leaf missing or left over, or
  a shape that differs, raises; a whole regressor built from a config
  round-trips.
* The torch replicas of torchvision/timm in ``tools/gen_backbone_fixtures.py``
  (the state-dict names of the real libraries) load into the port's
  backbones by name, strictly, and give the same outputs in process
  (same float32 operations: within 1e-5 × max(1, max |replica|)).
* The encoder UNets not held in ``tests/test_torch_models.py`` (ResNet-50,
  EfficientNet-B0/B3/B5, MobileNetV3, ConvNeXt encoders) are held to the JAX
  package at 32² through ``state_dict_from_flax``, at that file's backbone
  tolerance.
* ``load_pretrained_npz`` routes a dump into the backbone (``resnet*``,
  ``vit*``) or a ``unet_*``'s ``encoder``, refuses the from-scratch UNets
  and a ViT dump of another resolution; ``apply_pretrained_policy`` refuses
  a frozen random backbone.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smilify_tpu.models import backbones as jbb
from smilify_tpu.models import regressor as jreg

from smilify_tpu_torch.models import backbones as tbb
from smilify_tpu_torch.models import regressor as treg
from smilify_tpu_torch.models.weight_port import (
    apply_pretrained_policy,
    build_model,
    load_pretrained_npz,
    state_dict_from_flax,
)
from smilify_tpu_torch.train.config import load_config
from tests.test_torch_models import check_backbone, random_variables

REPO = pathlib.Path(__file__).resolve().parent.parent
REPLICA_TOL = 1e-5


def _replicas():
    spec = importlib.util.spec_from_file_location(
        "gen_backbone_fixtures", REPO / "tools" / "gen_backbone_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _replicas()
REG_KW = dict(backbone="unet_micro", n_pose=5, n_betas=3, n_joints=6, decoder_dim=32,
              decoder_depth=1, decoder_heads=4, ief_iters=2)


def _flax_regressor_variables():
    x = jnp.zeros((1, 32, 32, 3))
    return random_variables(jreg.SMILRegressor(jreg.RegressorConfig(compute_dtype=jnp.float32, **REG_KW)), x)


def test_state_dict_from_flax_builds_from_a_config():
    v = _flax_regressor_variables()
    cfg = treg.RegressorConfig(compute_dtype=torch.float32, **REG_KW)
    sd = state_dict_from_flax(v, cfg, img_size=32)
    model = build_model(cfg, img_size=32)
    model.load_state_dict(sd)          # strict
    assert sd["head.init_estimate"].shape == (6 + 30 + 3 + 3 + 1 + 9 + 3,)
    np.testing.assert_array_equal(
        sd["backbone.ConvBlock_0.BatchNorm_0.running_var"].numpy(),
        v["batch_stats"]["UNet_0"]["ConvBlock_0"]["BatchNorm_0"]["var"])


@pytest.mark.parametrize("fault", ["missing_leaf", "extra_leaf", "missing_stats", "wrong_shape"])
def test_state_dict_from_flax_is_strict(fault):
    v = _flax_regressor_variables()
    head = v["params"]["SMILTransformerDecoderHead_0"]
    if fault == "missing_leaf":
        del head["layer_0"]["Dense_1"]["bias"]
    elif fault == "extra_leaf":
        head["layer_0"]["Dense_9"] = {"kernel": np.zeros((32, 32), np.float32)}
    elif fault == "missing_stats":
        del v["batch_stats"]["UNet_0"]["ConvBlock_1"]
    else:
        head["memory_proj"]["kernel"] = np.zeros((31, 32), np.float32)
    with pytest.raises(ValueError):
        state_dict_from_flax(v, treg.RegressorConfig(compute_dtype=torch.float32, **REG_KW), 32)


@pytest.mark.parametrize("arch", ["resnet50", "efficientnet_b0", "efficientnet_b3",
                                  "efficientnet_b5", "mobilenetv3_large_100", "convnext_base"])
def test_unet_encoder_backbone_matches_jax(arch):
    widths = (256, 128, 64) if arch == "convnext_base" else (256, 128, 64, 32)
    check_backbone(jbb.UNetResNet(encoder_arch=arch, decoder_widths=widths, dtype=jnp.float32),
                   tbb.UNetResNet(encoder_arch=arch, decoder_widths=widths), 32)


# ---------------------------------------------------------------------------
# the torchvision/timm replicas
# ---------------------------------------------------------------------------


def _randomize_stats(model):
    torch.manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    return model.eval()


def _close(got, want, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert got.shape == want.shape and err <= REPLICA_TOL * scale, f"{what}: {err:.3g}"


REPLICAS = {
    "resnet": (lambda: G.ResNet50((1, 1, 1, 1), G.Bottleneck), lambda: tbb.ResNet([1, 1, 1, 1])),
    "resnet34_encoder": (lambda: G.ResNet50((1, 1, 1, 1), G.BasicBlock),
                         lambda: tbb.ResNetEncoder((1, 1, 1, 1), block="basic")),
    "resnet50_encoder": (lambda: G.ResNet50((1, 2, 1, 1), G.Bottleneck),
                         lambda: tbb.ResNetEncoder((1, 2, 1, 1), block="bottleneck")),
    "vit": (lambda: G.ViTB16(depth=2, dim=64, heads=4, img=64), lambda: tbb.ViT(2, 64, 4, img_size=64)),
    "efficientnet_b0": (lambda: G.EfficientNetB0("efficientnet_b0"), lambda: tbb.make_encoder("efficientnet_b0")),
    "mobilenetv3": (lambda: G.MobileNetV3Large(), lambda: tbb.make_encoder("mobilenetv3_large_100")),
    "convnext": (lambda: G.ConvNeXtBase(depths=(1, 1, 2, 1)),
                 lambda: tbb.ConvNeXtEncoder(depths=(1, 1, 2, 1))),
}


@pytest.mark.parametrize("name", sorted(REPLICAS))
def test_replica_state_dicts_load_by_name(name):
    rmake, tmake = REPLICAS[name]
    torch.manual_seed(0)
    replica = _randomize_stats(rmake())
    if hasattr(replica, "init_like_torchvision"):
        replica.init_like_torchvision()
    port = tmake()
    port.load_state_dict(replica.state_dict())          # strict: the same names and shapes
    port.eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(7))
    mean = torch.tensor(G.IMAGENET_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(G.IMAGENET_STD).view(1, 3, 1, 1)
    xn = (x.permute(0, 3, 1, 2) - mean) / std
    with torch.no_grad():
        if name == "resnet":
            _close(port(x).pooled, replica(xn), "pooled")
        elif name == "vit":
            pooled, tokens = replica(xn)
            out = port(x)
            _close(out.pooled, pooled, "pooled")
            _close(out.tokens, tokens, "tokens")
        else:
            got = port(xn.contiguous(memory_format=torch.channels_last))
            want = replica.forward_stages(xn)
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"stage {i}")


# ---------------------------------------------------------------------------
# pretrained dumps and the policy
# ---------------------------------------------------------------------------


def _dump(tmp_path, module, name="dump.npz"):
    path = tmp_path / name
    np.savez(path, **{k: v.numpy() for k, v in module.state_dict().items()})
    return str(path)


def _regressor(backbone, img_size=64):
    cfg = treg.RegressorConfig(backbone=backbone, n_pose=5, n_betas=3, n_joints=6, decoder_dim=32,
                               decoder_depth=1, decoder_heads=4, ief_iters=1)
    return treg.SMILRegressor(cfg, img_size=img_size)


def test_unet_dump_routes_into_the_encoder(tmp_path):
    torch.manual_seed(0)
    encoder = _randomize_stats(G.ResNet50((3, 4, 6, 3), G.BasicBlock))
    path = _dump(tmp_path, encoder)
    model = _regressor("unet_resnet34")
    decoder_before = model.backbone.Conv_0.weight.detach().clone()
    load_pretrained_npz(model, path, "unet_resnet34")
    for k, v in encoder.state_dict().items():
        assert torch.equal(model.backbone.encoder.state_dict()[k], v), k
    assert torch.equal(model.backbone.Conv_0.weight, decoder_before)   # the decoder keeps its init


def test_resnet_dump_routes_into_the_backbone_and_vit_resolution_is_checked(tmp_path):
    torch.manual_seed(0)
    model = _regressor("resnet50")
    replica = _randomize_stats(G.ResNet50((3, 4, 6, 3), G.Bottleneck))
    load_pretrained_npz(model, _dump(tmp_path, replica, "r50.npz"), "resnet50")
    assert torch.equal(model.backbone.layer3[5].bn2.running_var, replica.layer3[5].bn2.running_var)
    vit = _regressor("vit_base_patch16_224", img_size=224)
    with pytest.raises(ValueError, match="pos_embed"):
        load_pretrained_npz(vit, _dump(tmp_path, G.ViTB16(img=384), "vit384.npz"), "vit_base_patch16_224")
    with pytest.raises(ValueError, match="no torch weight source"):
        load_pretrained_npz(_regressor("unet_micro"), _dump(tmp_path, replica, "x.npz"), "unet_micro")


def test_frozen_random_backbone_refused(tmp_path):
    model = _regressor("unet_resnet34")
    cfg = load_config(None, overrides={"model.backbone_name": "unet_resnet34",
                                       "model.freeze_backbone": True})
    with pytest.raises(SystemExit, match="RANDOM"):
        apply_pretrained_policy(cfg, model)
    apply_pretrained_policy(cfg, model, allow_random_backbone=True)
    cfg.model.freeze_backbone = False
    apply_pretrained_policy(cfg, model)
    torch.manual_seed(0)
    cfg.model.freeze_backbone = True
    cfg.model.pretrained_npz = _dump(tmp_path, _randomize_stats(G.ResNet50((3, 4, 6, 3), G.BasicBlock)))
    apply_pretrained_policy(cfg, model)      # loads the dump instead of refusing
    assert torch.equal(model.backbone.encoder.conv1.weight,
                       torch.as_tensor(np.load(cfg.model.pretrained_npz)["conv1.weight"]))
