"""Image backbones (port of ``smilify_tpu/models/backbones.py``).

ResNet-50/101/152 (BatchNorm or GroupNorm), ViT-B/L-16, the from-scratch
UNets (``unet_small``, ``unet_mid``, ``unet_micro``) and the UNets over a
pretrained-style encoder (torchvision ResNet-34/50, timm EfficientNet-B0/B3/B5,
MobileNetV3-Large, ConvNeXt-Base). Every backbone takes NHWC images
``(B, H, W, 3)`` in [0, 1], as the JAX package does, and returns
:class:`BackboneFeatures`:

  * ``pooled``  — (B, D) global feature (GAP / CLS token),
  * ``tokens``  — (B, T, D) the final map ``(B, H', W', C)`` flattened
    row-major (ViT: its patch tokens), for the decoder's cross-attention,
  * ``spatial`` — (B, H', W', C) the final feature map,

all three in float32. Inside, the images are permuted once to NCHW in the
``channels_last`` layout, which is what cuDNN's NHWC convolutions read.

The weight-portable families carry torchvision/timm state-dict names
(``conv1``, ``layer1.0.conv1``, ``blocks.0.attn.qkv``, ``conv_stem``,
``stages.0.blocks.0.conv_dw``...), so a dump of those libraries loads by name
(``models/weight_port.py``). The from-scratch UNets and the UNet decoders
name their submodules as the Flax module tree does (``ConvBlock_0``,
``Conv_1``...). Each module's :meth:`flax_names` maps its children to the
Flax names, which ``weight_port.state_dict_from_flax`` walks.

Flax's defaults are kept where torch's differ: LayerNorm and GroupNorm eps
1e-6 (the ViT's LayerNorms set 1e-5, as timm's), BatchNorm momentum 0.99
(torch ``momentum=0.01``), ``'SAME'`` padding on the patchify convolutions
(bottom and right only, when the stride does not divide the size). Mixed
precision is the caller's ``torch.autocast``; the outputs are cast back to
float32 as the JAX backbones cast theirs.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from smilify_tpu_torch._device import shared_constant

# torchvision/timm normalization constants (inputs are [0,1] RGB)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_MOMENTUM = 0.01        # flax BatchNorm momentum 0.99
FLAX_LN_EPS = 1e-6        # flax LayerNorm / GroupNorm default


class BackboneFeatures(NamedTuple):
    pooled: torch.Tensor
    tokens: Optional[torch.Tensor]
    spatial: Optional[torch.Tensor]


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    mean = shared_constant(IMAGENET_MEAN, x.dtype, x.device)
    std = shared_constant(IMAGENET_STD, x.dtype, x.device)
    return (x - mean) / std


def _to_nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 1] images → normalized NCHW in the channels_last layout."""
    x = normalize_imagenet(images).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def _features(spatial_nchw: torch.Tensor, pooled: Optional[torch.Tensor] = None,
              token_pool: int = 0) -> BackboneFeatures:
    """float32 NHWC ``spatial``, its row-major ``tokens`` (after a
    ``token_pool``² average pool when given) and ``pooled`` (GAP of
    ``spatial`` unless given)."""
    spatial = spatial_nchw.float().permute(0, 2, 3, 1)
    if pooled is None:
        pooled = spatial.mean(dim=(1, 2))
    tok = spatial
    if token_pool:
        tok = F.avg_pool2d(spatial_nchw.float(), token_pool, token_pool).permute(0, 2, 3, 1)
    B, Ht, Wt, C = tok.shape
    return BackboneFeatures(pooled=pooled, tokens=tok.reshape(B, Ht * Wt, C), spatial=spatial)


def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Flax's ``'SAME'`` padding for a convolution that declares none: the
    total (k − s) or less, its larger half at the bottom and right."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running statistics move as Flax's
    ``nn.BatchNorm`` moves its ``batch_stats``: ``ra = 0.99·ra + 0.01·stat``
    with the **biased** batch variance, where torch takes the unbiased one
    (× n/(n − 1)). Normalization is torch's (the biased variance in train
    mode, the running statistics in eval mode), and the state-dict names
    are ``nn.BatchNorm2d``'s.

    Torch's update is kept (one fused pass over the activations) and its
    variance term scaled back by (n − 1)/n on the C running variances. It
    runs on copies of the statistics: autograd keeps the tensors it was
    given, and the correction may not change them in place.

    With ``process_group`` set to a group of more than one rank (the
    data-parallel trainer sets it: :func:`sync_batchnorm`), train mode
    normalizes with the statistics of the GLOBAL batch, as XLA computes
    them over a sharded batch, and the running statistics move with the
    biased variance as above. The statistics: each rank's per-channel sum,
    sum of squares and count summed over the group (one all-reduce), and
    Flax's E[x²] − E[x]². On the CPU :meth:`_global_batch_forward` computes
    the rest with elementwise ops under autograd (the all-reduce's backward
    sums the gradients the same way); on the card :class:`_GlobalBatchNorm`
    runs the fused passes ``SyncBatchNorm`` uses, which the CPU lacks."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None and dist.get_world_size(self.process_group) > 1:
            if x.is_cuda:
                return self._global_batch_forward_fused(x)
            return self._global_batch_forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, self.eps)
        with torch.no_grad():
            # var = kept + m·var_unbiased → kept + m·var_biased
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        from smilify_tpu_torch.train.multihost import AllReduceSum

        C = x.shape[1]
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        # the sums accumulate in float64: E[x²] − E[x]² cancels, and a
        # float32 sum over a global batch of activations rounds visibly
        f64 = torch.float64
        count = torch.full((1,), x.numel() // C, dtype=f64, device=x.device)
        stats = AllReduceSum.apply(
            torch.cat([xf.sum(dims, dtype=f64), (xf * xf).sum(dims, dtype=f64), count]),
            self.process_group)
        n = stats[2 * C]
        mean64 = stats[:C] / n
        mean, var = mean64.float(), (stats[C:2 * C] / n - mean64 * mean64).float()
        shape = [1, C] + [1] * (x.dim() - 2)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    def _global_batch_forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                              self.process_group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the group's global batch, on the
    card. The statistics are :meth:`FlaxBatchNorm2d._global_batch_forward`'s:
    each rank's per-channel sum and sum of squares (two reductions of one
    float64 copy of the activations, so E[x²] − E[x]² does not cancel) and
    its count, one all-reduce. The normalization and its backward are the
    fused passes ``SyncBatchNorm`` uses (``batch_norm_elemt``;
    ``batch_norm_backward_reduce`` and ``batch_norm_backward_elemt``, whose
    two per-channel sums are summed over the group, one all-reduce), not a
    chain of elementwise ops under autograd. Returns the output and the
    global mean and biased variance (float32), which move the running
    statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        C, f64 = x.shape[1], torch.float64
        dims = [d for d in range(x.dim()) if d != 1]
        xd = x.to(f64)          # once: a reduction asked for float64 would copy x itself
        stats = torch.cat([xd.sum(dims), torch.linalg.vector_norm(xd, 2, dims).square(),
                           x.new_full((1,), x.numel() // C, dtype=f64)])
        del xd
        dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
        n = stats[2 * C]
        mean64 = stats[:C] / n
        var64 = stats[C:2 * C] / n - mean64 * mean64
        mean, var = mean64.float(), var64.float()
        invstd = torch.rsqrt(var64 + eps).float()
        ctx.save_for_backward(x, weight, mean, invstd, n.to(torch.int32).reshape(1))
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        if not dy.is_contiguous(memory_format=torch.channels_last):
            dy = dy.contiguous()
        x, weight, mean, invstd, count = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, need_x, need_w, need_b)
        dx = None
        if need_x:
            C = sum_dy.shape[0]
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=ctx.group)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sums[:C], sums[C:],
                                                 count)
        return dx, dw if need_w else None, db if need_b else None, None, None


def sync_batchnorm(model: nn.Module, group) -> int:
    """Point every :class:`FlaxBatchNorm2d` of ``model`` at ``group`` (None:
    back to the rank's own batch). Returns how many it set."""
    n = 0
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.process_group = group
            n += 1
    return n


def _bn(c: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


def flax_init_(module: nn.Module) -> nn.Module:
    """Flax's default initializers on every convolution and linear layer of
    ``module``: LeCun normal (truncated at 2σ) kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


# ---------------------------------------------------------------------------
# ResNet (torchvision names: conv1/bn1/layer{L}.{b}.conv{k}/bn{k}/downsample)
# ---------------------------------------------------------------------------


def _norm(kind: str, c: int) -> nn.Module:
    """'batch' → BatchNorm; 'group' → GroupNorm(32), flax's eps."""
    if kind == "group":
        return nn.GroupNorm(32, c, eps=FLAX_LN_EPS)
    return _bn(c)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, norm="batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _norm(norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _norm(norm, planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _norm(norm, planes * 4)
        self.downsample = downsample
        self._norm_name = "GroupNorm" if norm == "group" else "BatchNorm"

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)

    def flax_names(self) -> Dict[str, str]:
        n = self._norm_name
        names = {f"conv{k}": f"Conv_{k - 1}" for k in (1, 2, 3)}
        names.update({f"bn{k}": f"{n}_{k - 1}" for k in (1, 2, 3)})
        if self.downsample is not None:
            names.update({"downsample.0": "Conv_3", "downsample.1": f"{n}_3"})
        return names


class BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet18/34)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, norm="batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)

    def flax_names(self) -> Dict[str, str]:
        names = {"conv1": "Conv_0", "bn1": "BatchNorm_0", "conv2": "Conv_1", "bn2": "BatchNorm_1"}
        if self.downsample is not None:
            names.update({"downsample.0": "Conv_2", "downsample.1": "BatchNorm_2"})
        return names


class _ResNetTrunk(nn.Module):
    """The torchvision ResNet trunk: stem, max pool, four stages."""

    def __init__(self, stage_sizes, block, norm="batch"):
        super().__init__()
        self.block = block
        self.norm = norm
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(norm, 64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.stage_sizes = tuple(stage_sizes)
        for i, n in enumerate(self.stage_sizes):
            setattr(self, f"layer{i + 1}", self._make_layer(64 * 2 ** i, n, 1 if i == 0 else 2))

    def _make_layer(self, planes, blocks, stride):
        exp = self.block.expansion
        downsample = None
        if stride != 1 or self.inplanes != planes * exp:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * exp, 1, stride=stride, bias=False),
                _norm(self.norm, planes * exp),
            )
        layers = [self.block(self.inplanes, planes, stride, downsample, norm=self.norm)]
        self.inplanes = planes * exp
        layers += [self.block(self.inplanes, planes, norm=self.norm) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward_stages(self, x):
        """The stem's output and each stage's (strides 2, 4, 8, 16, 32)."""
        x = F.relu(self.bn1(self.conv1(x)))
        stages = [x]
        x = self.maxpool(x)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
            stages.append(x)
        return stages

    def flax_names(self) -> Dict[str, str]:
        norm = "GroupNorm_0" if self.norm == "group" else "BatchNorm_0"
        names = {"conv1": "Conv_0", "bn1": norm}
        block = self.block.__name__
        k = 0
        for i, n in enumerate(self.stage_sizes):
            for b in range(n):
                names[f"layer{i + 1}.{b}"] = f"{block}_{k}"
                k += 1
        return names


class ResNet(_ResNetTrunk):
    """ResNet-v1 bottleneck backbone (50/101/152 by ``stage_sizes``);
    ``norm='group'`` swaps every BatchNorm for GroupNorm(32)."""

    def __init__(self, stage_sizes: Sequence[int], norm: str = "batch"):
        super().__init__(stage_sizes, Bottleneck, norm)

    def forward(self, images: torch.Tensor) -> BackboneFeatures:
        return _features(self.forward_stages(_to_nchw(images))[-1])


class ResNetEncoder(_ResNetTrunk):
    """torchvision resnet34 (``block='basic'``) or resnet50
    (``'bottleneck'``) trunk exposing the five UNet skip stages."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), block: str = "basic"):
        super().__init__(stage_sizes, Bottleneck if block == "bottleneck" else BasicBlock)

    def forward(self, x):
        return self.forward_stages(x)


# ---------------------------------------------------------------------------
# ViT (timm names: patch_embed.proj, cls_token, pos_embed, blocks.{i}.*, norm)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """timm's fused-qkv self-attention; Flax's query/key/value/out
    (``nn.MultiHeadDotProductAttention``) load into it by
    :meth:`load_flax`."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(y.transpose(1, 2).reshape(B, N, D))

    @staticmethod
    def load_flax(tree) -> Dict[str, torch.Tensor]:
        """{state key: tensor} from Flax's MHA params (kernels (D, H, Dh) and
        (H, Dh, D)); every leaf of ``tree`` is read."""
        D = tree["query"]["kernel"].shape[0]
        w = [torch.as_tensor(tree[n]["kernel"]).reshape(D, D).T for n in ("query", "key", "value")]
        b = [torch.as_tensor(tree[n]["bias"]).reshape(D) for n in ("query", "key", "value")]
        return {"qkv.weight": torch.cat(w), "qkv.bias": torch.cat(b),
                "proj.weight": torch.as_tensor(tree["out"]["kernel"]).reshape(D, D).T,
                "proj.bias": torch.as_tensor(tree["out"]["bias"])}


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact-erf GELU, as timm's


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))

    def flax_names(self) -> Dict[str, str]:
        return {"norm1": "LayerNorm_0", "attn": "MultiHeadDotProductAttention_0",
                "norm2": "LayerNorm_1", "mlp.fc1": "Dense_0", "mlp.fc2": "Dense_1"}


class _PatchEmbed(nn.Module):
    def __init__(self, dim, patch):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(_pad_same(x, self.patch, self.patch))


class ViT(nn.Module):
    """ViT-16 (base: 12×768, large: 24×1024) with CLS token + patch tokens.
    ``pos_embed`` has the length of ``img_size``'s patch grid, as the Flax
    ViT fixes it at init from the resolution it is initialized at."""

    def __init__(self, depth: int, dim: int, num_heads: int, patch: int = 16,
                 img_size: int = 224):
        super().__init__()
        self.dim, self.patch = dim, patch
        n = -(-img_size // patch)
        self.patch_embed = _PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n * n + 1, dim) * 0.02)
        self.blocks = nn.Sequential(*[TransformerBlock(dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, images: torch.Tensor) -> BackboneFeatures:
        x = self.patch_embed(_to_nchw(images))
        B, D, Hs, Ws = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, 1, D).to(x.dtype), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x = self.norm(self.blocks(x)).float()
        tokens = x[:, 1:]
        return BackboneFeatures(pooled=x[:, 0], tokens=tokens,
                                spatial=tokens.reshape(B, Hs, Ws, D))

    def flax_names(self) -> Dict[str, str]:
        names = {"patch_embed.proj": "patch_embed", "cls_token": "cls_token",
                 "pos_embed": "pos_embed", "norm": "norm"}
        names.update({f"blocks.{i}": f"TransformerBlock_{i}" for i in range(len(self.blocks))})
        return names


# ---------------------------------------------------------------------------
# UNet (from scratch; names mirror the Flax tree)
# ---------------------------------------------------------------------------


class ConvBlock(nn.Module):
    """Two (3×3 conv, BatchNorm, ReLU)."""

    def __init__(self, cin, features):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = _bn(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = _bn(features)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UNet(nn.Module):
    """Encoder-decoder with skips; pooled = GAP of the bottleneck, tokens =
    the output map average-pooled 8×8."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512, 1024), out_dim: int = 512):
        super().__init__()
        self.widths = tuple(widths)
        n = len(self.widths)
        cin = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, w))
            cin = w
        for j, w in enumerate(reversed(self.widths[:-1])):
            setattr(self, f"Conv_{j}", nn.Conv2d(cin, w, 3, padding=1))
            setattr(self, f"ConvBlock_{n + j}", ConvBlock(2 * w, w))
            cin = w
        setattr(self, f"Conv_{n - 1}", nn.Conv2d(cin, out_dim, 1))

    def forward(self, images: torch.Tensor) -> BackboneFeatures:
        x = _to_nchw(images)
        n = len(self.widths)
        skips = []
        for i in range(n - 1):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = getattr(self, f"ConvBlock_{n - 1}")(x)
        bottleneck = x
        for j, skip in enumerate(reversed(skips)):
            x = getattr(self, f"Conv_{j}")(_up2(x))
            x = getattr(self, f"ConvBlock_{n + j}")(torch.cat([x, skip], dim=1))
        x = getattr(self, f"Conv_{n - 1}")(x)
        return _features(x, pooled=bottleneck.float().mean(dim=(2, 3)), token_pool=8)


# ---------------------------------------------------------------------------
# EfficientNet-B0/B3/B5 encoder (timm names: conv_stem/bn1/blocks.{s}.{b}.*)
# ---------------------------------------------------------------------------

# (block_type, num_blocks, kernel, first_stride, expand_ratio, out_channels)
EFFICIENTNET_B0_STAGES = (
    ("ds", 1, 3, 1, 1, 16), ("ir", 2, 3, 2, 6, 24), ("ir", 2, 5, 2, 6, 40),
    ("ir", 3, 3, 2, 6, 80), ("ir", 3, 5, 1, 6, 112), ("ir", 4, 5, 2, 6, 192),
    ("ir", 1, 3, 1, 6, 320),
)
EFFICIENTNET_B3_STAGES = (
    ("ds", 2, 3, 1, 1, 24), ("ir", 3, 3, 2, 6, 32), ("ir", 3, 5, 2, 6, 48),
    ("ir", 5, 3, 2, 6, 96), ("ir", 5, 5, 1, 6, 136), ("ir", 6, 5, 2, 6, 232),
    ("ir", 2, 3, 1, 6, 384),
)
EFFICIENTNET_B5_STAGES = (
    ("ds", 3, 3, 1, 1, 24), ("ir", 5, 3, 2, 6, 40), ("ir", 5, 5, 2, 6, 64),
    ("ir", 7, 3, 2, 6, 128), ("ir", 7, 5, 1, 6, 176), ("ir", 9, 5, 2, 6, 304),
    ("ir", 3, 3, 1, 6, 512),
)
EFFICIENTNET_VARIANTS = {
    "efficientnet_b0": (32, EFFICIENTNET_B0_STAGES, 320),
    "efficientnet_b3": (40, EFFICIENTNET_B3_STAGES, 384),
    "efficientnet_b5": (48, EFFICIENTNET_B5_STAGES, 512),
}
# stages whose output is a UNet skip feature (strides 2, 4, 8, 16, 32)
_EFFNET_FEATURE_STAGES = (0, 1, 2, 4, 6)


class SqueezeExcite(nn.Module):
    """GAP → conv_reduce → act → conv_expand → gate (SiLU + sigmoid for
    EfficientNet; ReLU + hard-sigmoid for MobileNetV3)."""

    def __init__(self, chs, reduced, mnv3=False):
        super().__init__()
        self.mnv3 = mnv3
        self.conv_reduce = nn.Conv2d(chs, reduced, 1, bias=True)
        self.conv_expand = nn.Conv2d(reduced, chs, 1, bias=True)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        if self.mnv3:
            return x * F.hardsigmoid(self.conv_expand(F.relu(self.conv_reduce(s))))
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))


class DepthwiseSeparableConv(nn.Module):
    """timm effnet stage-0 block: dw → SE → pw-linear."""

    def __init__(self, in_chs, out_chs, k=3):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_chs, in_chs, k, padding=k // 2, groups=in_chs, bias=False)
        self.bn1 = _bn(in_chs)
        self.se = SqueezeExcite(in_chs, max(1, int(in_chs * 0.25)))
        self.conv_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = _bn(out_chs)
        self.has_residual = in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(self.se(y)))
        return y + x if self.has_residual else y


class InvertedResidual(nn.Module):
    """timm effnet MBConv: pw-expand → dw → SE → pw-linear (+residual)."""

    def __init__(self, in_chs, out_chs, k=3, stride=1, expand=6):
        super().__init__()
        mid = in_chs * expand
        self.conv_pw = nn.Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = nn.Conv2d(mid, mid, k, stride=stride, padding=k // 2, groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_chs * 0.25)))
        self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = _bn(out_chs)
        self.has_residual = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.has_residual else y


def _blocks_flax_names(blocks: nn.Sequential) -> Dict[str, str]:
    return {f"blocks.{s}.{b}": f"blocks_{s}_{b}"
            for s, stage in enumerate(blocks) for b in range(len(stage))}


class EfficientNetEncoder(nn.Module):
    """timm efficientnet_b0/b3/b5 trunk exposing the five UNet skip stages."""

    def __init__(self, stem_ch: int = 32, stages: tuple = EFFICIENTNET_B0_STAGES):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, stem_ch, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(stem_ch)
        blocks = []
        in_chs = stem_ch
        for kind, n_blocks, k, stride, expand, out_chs in stages:
            stage = []
            for b in range(n_blocks):
                if kind == "ds":
                    stage.append(DepthwiseSeparableConv(in_chs, out_chs, k))
                else:
                    stage.append(InvertedResidual(in_chs, out_chs, k, stride if b == 0 else 1, expand))
                in_chs = out_chs
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        feats = []
        for s, stage in enumerate(self.blocks):
            x = stage(x)
            if s in _EFFNET_FEATURE_STAGES:
                feats.append(x)
        return feats

    def flax_names(self) -> Dict[str, str]:
        return {"conv_stem": "conv_stem", "bn1": "bn1", **_blocks_flax_names(self.blocks)}


# ---------------------------------------------------------------------------
# MobileNetV3-Large encoder (timm mobilenetv3_large_100 names)
# ---------------------------------------------------------------------------

# per-block entries: (kind, kernel, stride, mid_ch, out_ch, act, se_ch); se_ch=0 → no SE
MOBILENETV3_LARGE_STAGES = (
    (("ds", 3, 1, 16, 16, "relu", 0),),
    (("ir", 3, 2, 64, 24, "relu", 0),
     ("ir", 3, 1, 72, 24, "relu", 0)),
    (("ir", 5, 2, 72, 40, "relu", 24),
     ("ir", 5, 1, 120, 40, "relu", 32),
     ("ir", 5, 1, 120, 40, "relu", 32)),
    (("ir", 3, 2, 240, 80, "hswish", 0),
     ("ir", 3, 1, 200, 80, "hswish", 0),
     ("ir", 3, 1, 184, 80, "hswish", 0),
     ("ir", 3, 1, 184, 80, "hswish", 0)),
    (("ir", 3, 1, 480, 112, "hswish", 120),
     ("ir", 3, 1, 672, 112, "hswish", 168)),
    (("ir", 5, 2, 672, 160, "hswish", 168),
     ("ir", 5, 1, 960, 160, "hswish", 240),
     ("ir", 5, 1, 960, 160, "hswish", 240)),
    (("cn", 1, 1, 0, 960, "hswish", 0),),
)
_MNV3_FEATURE_STAGES = (0, 1, 2, 4, 6)
MOBILENETV3_FEATURE_DIM = 960
_ACTS = {"relu": F.relu, "hswish": F.hardswish}


class MNV3Block(nn.Module):
    """One mobilenetv3 block in timm's layouts: ds (conv_dw/bn1[/se]/conv_pw/
    bn2), ir (conv_pw/bn1/conv_dw/bn2[/se]/conv_pwl/bn3), cn (conv/bn1)."""

    def __init__(self, in_chs, kind, k, stride, mid, out_chs, act, se_ch):
        super().__init__()
        self.kind, self.act = kind, _ACTS[act]
        if kind == "cn":
            self.conv = nn.Conv2d(in_chs, out_chs, k, stride=stride, padding=k // 2, bias=False)
            self.bn1 = _bn(out_chs)
        elif kind == "ds":
            self.conv_dw = nn.Conv2d(in_chs, in_chs, k, stride=stride, padding=k // 2,
                                     groups=in_chs, bias=False)
            self.bn1 = _bn(in_chs)
            if se_ch:
                self.se = SqueezeExcite(in_chs, se_ch, mnv3=True)
            self.conv_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
            self.bn2 = _bn(out_chs)
        else:
            self.conv_pw = nn.Conv2d(in_chs, mid, 1, bias=False)
            self.bn1 = _bn(mid)
            self.conv_dw = nn.Conv2d(mid, mid, k, stride=stride, padding=k // 2, groups=mid, bias=False)
            self.bn2 = _bn(mid)
            if se_ch:
                self.se = SqueezeExcite(mid, se_ch, mnv3=True)
            self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
            self.bn3 = _bn(out_chs)
        self.has_residual = kind != "cn" and stride == 1 and in_chs == out_chs

    def forward(self, x):
        if self.kind == "cn":
            return self.act(self.bn1(self.conv(x)))
        if self.kind == "ds":
            y = self.act(self.bn1(self.conv_dw(x)))
            if hasattr(self, "se"):
                y = self.se(y)
            y = self.bn2(self.conv_pw(y))
        else:
            y = self.act(self.bn1(self.conv_pw(x)))
            y = self.act(self.bn2(self.conv_dw(y)))
            if hasattr(self, "se"):
                y = self.se(y)
            y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_residual else y


class MobileNetV3Encoder(nn.Module):
    """timm mobilenetv3_large_100 trunk exposing the five UNet skip stages."""

    def __init__(self, stages: tuple = MOBILENETV3_LARGE_STAGES):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 16, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(16)
        blocks = []
        in_chs = 16
        for stage in stages:
            mods = []
            for (kind, k, stride, mid, out_chs, act, se_ch) in stage:
                mods.append(MNV3Block(in_chs, kind, k, stride, mid, out_chs, act, se_ch))
                in_chs = out_chs
            blocks.append(nn.Sequential(*mods))
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        x = F.hardswish(self.bn1(self.conv_stem(x)))
        feats = []
        for s, stage in enumerate(self.blocks):
            x = stage(x)
            if s in _MNV3_FEATURE_STAGES:
                feats.append(x)
        return feats

    def flax_names(self) -> Dict[str, str]:
        return {"conv_stem": "conv_stem", "bn1": "bn1", **_blocks_flax_names(self.blocks)}


# ---------------------------------------------------------------------------
# ConvNeXt-Base encoder (timm names: stem.{0,1}, stages.{s}.downsample.{0,1},
# stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma})
# ---------------------------------------------------------------------------

CONVNEXT_BASE_DEPTHS = (3, 3, 27, 3)
CONVNEXT_BASE_DIMS = (128, 256, 512, 1024)
CONVNEXT_FEATURE_DIM = CONVNEXT_BASE_DIMS[-1]


def _ln_nchw(norm, x):
    """A channels-last LayerNorm on an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, bias=True)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.mlp(self.norm(self.conv_dw(x).permute(0, 2, 3, 1)))
        return x + (self.gamma.to(y.dtype) * y).permute(0, 3, 1, 2)

    def flax_names(self) -> Dict[str, str]:
        return {"conv_dw": "conv_dw", "norm": "norm", "mlp.fc1": "mlp_fc1",
                "mlp.fc2": "mlp_fc2", "gamma": "gamma"}


class _ConvNeXtStage(nn.Module):
    def __init__(self, cin, dim, depth, downsample):
        super().__init__()
        if downsample:
            self.downsample = nn.Sequential(nn.LayerNorm(cin, eps=1e-6),
                                            nn.Conv2d(cin, dim, 2, stride=2, bias=True))
        self.blocks = nn.Sequential(*[ConvNeXtBlock(dim) for _ in range(depth)])


class ConvNeXtEncoder(nn.Module):
    """timm convnext_base trunk exposing the four feature stages
    (strides 4, 8, 16, 32); LayerNorm only."""

    def __init__(self, depths: Sequence[int] = CONVNEXT_BASE_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_BASE_DIMS):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4, bias=True),
                                  nn.LayerNorm(dims[0], eps=1e-6))
        self.stages = nn.Sequential(*[
            _ConvNeXtStage(dims[max(s - 1, 0)], dim, depth, s > 0)
            for s, (depth, dim) in enumerate(zip(depths, dims))])

    def forward(self, x):
        x = _ln_nchw(self.stem[1], self.stem[0](_pad_same(x, 4, 4)))
        feats = []
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = stage.downsample[1](_pad_same(_ln_nchw(stage.downsample[0], x), 2, 2))
            x = stage.blocks(x)
            feats.append(x)
        return feats

    def flax_names(self) -> Dict[str, str]:
        names = {"stem.0": "stem_conv", "stem.1": "stem_norm"}
        for s, stage in enumerate(self.stages):
            if s > 0:
                names[f"stages.{s}.downsample.0"] = f"stages_{s}_downsample_norm"
                names[f"stages.{s}.downsample.1"] = f"stages_{s}_downsample_conv"
            for b in range(len(stage.blocks)):
                names[f"stages.{s}.blocks.{b}"] = f"stages_{s}_blocks_{b}"
        return names


# ---------------------------------------------------------------------------
# UNet over a portable encoder
# ---------------------------------------------------------------------------

_ENCODER_CHANNELS = {
    "resnet34": (64, 64, 128, 256, 512),
    "resnet50": (64, 256, 512, 1024, 2048),
    "efficientnet_b0": (16, 24, 40, 112, 320),
    "efficientnet_b3": (24, 32, 48, 136, 384),
    "efficientnet_b5": (24, 40, 64, 176, 512),
    "mobilenetv3_large_100": (16, 24, 40, 112, 960),
    "convnext_base": CONVNEXT_BASE_DIMS,
}


def make_encoder(arch: str) -> nn.Module:
    if arch in EFFICIENTNET_VARIANTS:
        stem, stages, _ = EFFICIENTNET_VARIANTS[arch]
        return EfficientNetEncoder(stem_ch=stem, stages=stages)
    if arch == "convnext_base":
        return ConvNeXtEncoder()
    if arch == "mobilenetv3_large_100":
        return MobileNetV3Encoder()
    return ResNetEncoder(block="bottleneck" if arch == "resnet50" else "basic")


class UNetResNet(nn.Module):
    """UNet with a weight-portable encoder (``encoder``, torchvision/timm
    names) and a skip decoder (Flax names ``Conv_j``/``ConvBlock_j``). The
    decoder zips its widths against the encoder's skips, deepest first, so
    it runs len(stages) − 1 decode steps (three for ConvNeXt's four
    stages). The class name is the Flax one."""

    def __init__(self, encoder_arch: str = "resnet34",
                 decoder_widths: Sequence[int] = (256, 128, 64, 32), out_dim: int = 512):
        super().__init__()
        self.encoder_arch = encoder_arch
        self.encoder = make_encoder(encoder_arch)
        chans = _ENCODER_CHANNELS[encoder_arch]
        skips = list(reversed(chans[:-1]))
        self.n_dec = min(len(decoder_widths), len(skips))
        cin = chans[-1]
        for j, (w, cs) in enumerate(zip(decoder_widths, skips)):
            setattr(self, f"Conv_{j}", nn.Conv2d(cin, w, 3, padding=1))
            setattr(self, f"ConvBlock_{j}", ConvBlock(w + cs, w))
            cin = w
        setattr(self, f"Conv_{self.n_dec}", nn.Conv2d(cin, out_dim, 1))

    def forward(self, images: torch.Tensor) -> BackboneFeatures:
        stages = self.encoder(_to_nchw(images))
        bottleneck = stages[-1]
        y = bottleneck
        for j, skip in enumerate(list(reversed(stages[:-1]))[: self.n_dec]):
            y = getattr(self, f"Conv_{j}")(_up2(y))
            y = getattr(self, f"ConvBlock_{j}")(torch.cat([y, skip], dim=1))
        y = getattr(self, f"Conv_{self.n_dec}")(y)
        return _features(y, pooled=bottleneck.float().mean(dim=(2, 3)), token_pool=8)


# ---------------------------------------------------------------------------
# factory (the JAX package's BACKBONES, same names and feature dims)
# ---------------------------------------------------------------------------

BACKBONES: dict = {
    "resnet50": lambda **kw: (ResNet([3, 4, 6, 3]), 2048),
    "resnet50_gn": lambda **kw: (ResNet([3, 4, 6, 3], norm="group"), 2048),
    "resnet101": lambda **kw: (ResNet([3, 4, 23, 3]), 2048),
    "resnet152": lambda **kw: (ResNet([3, 8, 36, 3]), 2048),
    "vit_base_patch16_224": lambda img_size=224: (ViT(12, 768, 12, img_size=img_size), 768),
    "vit_large_patch16_224": lambda img_size=224: (ViT(24, 1024, 16, img_size=img_size), 1024),
    "unet_resnet34": lambda **kw: (UNetResNet(), 512),
    "unet_resnet50": lambda **kw: (UNetResNet(encoder_arch="resnet50"), 2048),
    "unet_efficientnet_b0": lambda **kw: (UNetResNet(encoder_arch="efficientnet_b0"), 320),
    "unet_efficientnet_b3": lambda **kw: (UNetResNet(encoder_arch="efficientnet_b3"), 384),
    "unet_efficientnet_b5": lambda **kw: (UNetResNet(encoder_arch="efficientnet_b5"), 512),
    "unet_convnext_base": lambda **kw: (
        UNetResNet(encoder_arch="convnext_base", decoder_widths=(256, 128, 64)),
        CONVNEXT_FEATURE_DIM),
    "unet_mobilenet_v3": lambda **kw: (
        UNetResNet(encoder_arch="mobilenetv3_large_100"), MOBILENETV3_FEATURE_DIM),
    "unet_small": lambda **kw: (UNet(widths=(32, 64, 128, 256), out_dim=256), 256),
    "unet_mid": lambda **kw: (UNet(widths=(64, 128, 256, 512), out_dim=512), 512),
    "unet_micro": lambda **kw: (UNet(widths=(8, 16, 32), out_dim=32), 32),
}

# the encoder archs whose dumps load into a UNetResNet's ``encoder``
UNET_ENCODER_BACKBONES = ("unet_resnet34", "unet_resnet50", "unet_efficientnet_b0",
                          "unet_efficientnet_b3", "unet_efficientnet_b5",
                          "unet_convnext_base", "unet_mobilenet_v3")


def create_backbone(name: str, img_size: int = 224):
    """(module, feature_dim) for a supported backbone name, Flax's
    initializers applied; ``img_size`` fixes the ViTs' ``pos_embed`` length
    (the Flax ViT takes it from the resolution it is initialized at)."""
    if name not in BACKBONES:
        raise ValueError(f"unsupported backbone {name}; choose from {sorted(BACKBONES)}")
    module, dim = BACKBONES[name](img_size=img_size)
    return flax_init_(module), dim
