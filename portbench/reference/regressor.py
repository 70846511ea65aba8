"""The single-view regressor in plain PyTorch: a ResNet-50 backbone (He et
al. 2016, torchvision's ``resnet50`` layout and names, BatchNorm eps 1e-5)
over ImageNet-normalized 224² images, its 7×7×2048 map as 49 tokens, and
SMILify's IEF transformer-decoder head (``neuralSMIL``: one query token
embedding the running estimate, ``depth`` pre-norm decoder layers of self-
and cross-attention and a tanh-GELU MLP, LayerNorm eps 1e-6, a linear head a
parameter group adding its delta to the estimate, ``iters`` times). The
decode turns 6D rotations (Zhou et al. 2019, Gram-Schmidt over the rows)
into axis-angle through the quaternion, the camera rotation from the first
six of its nine outputs; the SMIL forward poses the mesh and the predicted
FoV camera projects its keypoints. The training loss is SMILify's
single-view loss at the weights the cell states; the optimizer is Adam.

Everything runs in float32 (TF32 off); ``conv`` replaces the backbone's
convolution, which is how the control computes it in a lower precision.
Weights are a dict keyed by the torchvision/Flax-style names of
:func:`layout`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import smil

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))       # (planes, blocks); expansion 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS, LN_EPS = 1e-5, 1e-6


def group_dims(J: int, B: int):
    return (("global_rot", 6), ("joint_rot", 6 * (J - 1)), ("betas", B), ("trans", 3),
            ("fov", 1), ("cam_rot", 9), ("cam_trans", 3))


def layout(head: dict, J: int, B: int):
    """[(name, shape, kind)] of every parameter and BatchNorm statistic;
    kind says how :func:`portbench.inputs.regressor_weights` fills it."""
    out = [("backbone.conv1.weight", (64, 3, 7, 7), "conv")]

    def bn(name, c, gamma="one"):
        out.extend([(f"{name}.weight", (c,), gamma), (f"{name}.bias", (c,), "zero"),
                    (f"{name}.running_mean", (c,), "stat_mean"),
                    (f"{name}.running_var", (c,), "stat_var"),
                    (f"{name}.num_batches_tracked", (), "count")])

    bn("backbone.bn1", 64)
    cin = 64
    for li, (planes, blocks) in enumerate(STAGES):
        for b in range(blocks):
            pre = f"backbone.layer{li + 1}.{b}"
            out.append((f"{pre}.conv1.weight", (planes, cin, 1, 1), "conv"))
            bn(f"{pre}.bn1", planes)
            out.append((f"{pre}.conv2.weight", (planes, planes, 3, 3), "conv"))
            bn(f"{pre}.bn2", planes)
            out.append((f"{pre}.conv3.weight", (planes * 4, planes, 1, 1), "conv"))
            bn(f"{pre}.bn3", planes * 4, "residual_gamma")
            if b == 0:
                out.append((f"{pre}.downsample.0.weight", (planes * 4, cin, 1, 1), "conv"))
                bn(f"{pre}.downsample.1", planes * 4)
            cin = planes * 4
    D, total = head["dim"], sum(d for _, d in group_dims(J, B))
    mlp = head["mlp_ratio"] * D

    def linear(name, n_out, n_in, kind="linear"):
        out.extend([(f"{name}.weight", (n_out, n_in), kind), (f"{name}.bias", (n_out,), "zero")])

    def norm(name, n):
        out.extend([(f"{name}.weight", (n,), "one"), (f"{name}.bias", (n,), "zero")])

    out.append(("head.init_estimate", (total,), "init_estimate"))
    linear("head.memory_proj", D, cin)
    linear("head.estimate_embed", D, total)
    norm("head.estimate_norm", total)
    for i in range(head["depth"]):
        pre = f"head.layer_{i}"
        for a in range(2):
            norm(f"{pre}.LayerNorm_{a}", D)
            for proj in ("query", "key", "value", "out"):
                linear(f"{pre}.MultiHeadDotProductAttention_{a}.{proj}", D, D)
        norm(f"{pre}.LayerNorm_2", D)
        linear(f"{pre}.Dense_0", mlp, D)
        linear(f"{pre}.Dense_1", D, mlp)
    for name, d in group_dims(J, B):
        linear(f"head.head_{name}", d, D, "head")
    return out


def initial_estimate(J: int, B: int) -> torch.Tensor:
    """The IEF start: 6D identities, the identity camera, fov 60, the camera 2.7 back."""
    ident6 = [1.0, 0, 0, 0, 1.0, 0]
    return torch.tensor(ident6 + ident6 * (J - 1) + [0.0] * B + [0.0] * 3 + [60.0]
                        + [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0] + [0.0, 0.0, 2.7])


def _bn(x, w, name, train, stats=None):
    if train:
        mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean, var)
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
            * w[f"{name}.weight"].view(shape) + w[f"{name}.bias"].view(shape))


def _block(x, w, pre, stride, train, conv, stats=None):
    out = F.relu(_bn(conv(x, w[f"{pre}.conv1.weight"]), w, f"{pre}.bn1", train, stats))
    out = F.relu(_bn(conv(out, w[f"{pre}.conv2.weight"], stride=stride, padding=1), w,
                     f"{pre}.bn2", train, stats))
    out = _bn(conv(out, w[f"{pre}.conv3.weight"]), w, f"{pre}.bn3", train, stats)
    if f"{pre}.downsample.0.weight" in w:
        x = _bn(conv(x, w[f"{pre}.downsample.0.weight"], stride=stride), w,
                f"{pre}.downsample.1", train, stats)
    return F.relu(out + x)


def backbone(w, images, train, conv=F.conv2d, stats=None):
    """NHWC [0, 1] images → (B, 49, 2048) tokens; each bottleneck block is
    checkpointed under autograd (its activations recomputed in the backward).
    In train mode ``stats`` (a dict), when given, collects each BatchNorm's
    batch mean and biased variance by name."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(_bn(conv(x, w["backbone.conv1.weight"], stride=2, padding=3), w,
                   "backbone.bn1", train, stats))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (_, blocks) in enumerate(STAGES):
        for b in range(blocks):
            pre = f"backbone.layer{li + 1}.{b}"
            stride = 2 if (b == 0 and li > 0) else 1
            # the weights ride as arguments, so the checkpoint sees what it must
            # recompute through
            names = [k for k in w if k.startswith(pre + ".")]
            run = (lambda x_, *vals, pre=pre, stride=stride, names=names:
                   _block(x_, dict(zip(names, vals)), pre, stride, train, conv, stats))
            vals = [w[k] for k in names]
            x = (checkpoint(run, x, *vals, use_reentrant=False) if torch.is_grad_enabled()
                 else run(x, *vals))
    B, C = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(B, -1, C)


def _linear(w, name, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def _attend(w, name, xq, xkv, heads):
    B, Lq, D = xq.shape
    h = D // heads
    q = _linear(w, f"{name}.query", xq).view(B, Lq, heads, h).transpose(1, 2)
    k = _linear(w, f"{name}.key", xkv).view(B, -1, heads, h).transpose(1, 2)
    v = _linear(w, f"{name}.value", xkv).view(B, -1, heads, h).transpose(1, 2)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(h), -1)
    return _linear(w, f"{name}.out", (att @ v).transpose(1, 2).reshape(B, Lq, D))


def head(w, tokens, cfg, J, B):
    """IEF decoder: tokens (B, T, C) → raw parameter groups {name: (B, d)}."""
    memory = _linear(w, "head.memory_proj", tokens)
    est = w["head.init_estimate"].expand(tokens.shape[0], -1)
    dims = group_dims(J, B)
    for _ in range(cfg["iters"]):
        q = _linear(w, "head.estimate_embed", _ln(w, "head.estimate_norm", est))[:, None]
        for i in range(cfg["depth"]):
            pre = f"head.layer_{i}"
            y = _ln(w, f"{pre}.LayerNorm_0", q)
            q = q + _attend(w, f"{pre}.MultiHeadDotProductAttention_0", y, y, cfg["heads"])
            y = _ln(w, f"{pre}.LayerNorm_1", q)
            q = q + _attend(w, f"{pre}.MultiHeadDotProductAttention_1", y, memory, cfg["heads"])
            y = _ln(w, f"{pre}.LayerNorm_2", q)
            q = q + _linear(w, f"{pre}.Dense_1",
                            F.gelu(_linear(w, f"{pre}.Dense_0", y), approximate="tanh"))
        est = est + torch.cat([_linear(w, f"head.head_{n}", q[:, 0]) for n, _ in dims], -1)
    out, off = {}, 0
    for n, d in dims:
        out[n] = est[:, off:off + d]
        off += d
    return out


def rot6d_to_matrix(d6):
    """6D → rotation matrix, rows b1, b2, b3 (non-finite entries as 0, a
    first row of norm < 1e-6 as the identity)."""
    d6 = torch.nan_to_num(d6, nan=0.0, posinf=0.0, neginf=0.0)
    ident = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=d6.device).expand_as(d6)
    d6 = torch.where(torch.linalg.vector_norm(d6[..., :3], dim=-1, keepdim=True) < 1e-6, ident, d6)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), 1e-8)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.clamp_min(torch.linalg.vector_norm(a2, dim=-1, keepdim=True), 1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -2)


def matrix_to_axis_angle(R):
    """Through the unit quaternion of the best-conditioned of its four
    closed forms (w ≥ 0), then 2·atan2(|xyz|, w) about xyz/|xyz|."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    sq = lambda v: torch.sqrt(torch.clamp_min(v, 1e-12)) / 2  # noqa: E731
    w0 = sq(1 + tr)
    x1 = sq(1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2])
    y2 = sq(1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2])
    z3 = sq(1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2])
    a, b, c = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]
    s01, s02, s12 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack([
        torch.stack([w0, a / (4 * w0), b / (4 * w0), c / (4 * w0)], -1),
        torch.stack([a / (4 * x1), x1, s01 / (4 * x1), s02 / (4 * x1)], -1),
        torch.stack([b / (4 * y2), s01 / (4 * y2), y2, s12 / (4 * y2)], -1),
        torch.stack([c / (4 * z3), s02 / (4 * z3), s12 / (4 * z3), z3], -1)], -2)
    score = torch.stack([tr, 2 * m[..., 0, 0] - tr, 2 * m[..., 1, 1] - tr, 2 * m[..., 2, 2] - tr], -1)
    q = torch.gather(cands, -2, score.argmax(-1)[..., None, None].expand(score.shape[:-1] + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., :1] < 0, -q, q)
    xyz, wq = q[..., 1:], torch.clamp(q[..., 0], -1.0, 1.0)
    nsq = (xyz * xyz).sum(-1, keepdim=True)
    small = nsq < 1e-14
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    angle = 2 * torch.atan2(sin_half[..., 0], wq)[..., None]
    return torch.where(small, 2 * xyz, xyz / sin_half * angle)


def axis_angle_to_matrix(aa):
    """Rodrigues with R ≈ I + [aa]× below an angle of 1e-6."""
    nsq = (aa * aa).sum(-1, keepdim=True)
    small = nsq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    k = torch.where(small, torch.zeros_like(aa), aa / angle)
    angle = torch.where(small, torch.zeros_like(angle), angle)

    def skew(v):
        x, y, z = v.unbind(-1)
        o = torch.zeros_like(x)
        return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(v.shape + (3,))

    eye = torch.eye(3, device=aa.device)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    R = c * eye + (1 - c) * k[..., :, None] * k[..., None, :] + s * skew(k)
    return torch.where(small[..., None], eye + skew(aa), R)


def decode(raw, J):
    B = raw["global_rot"].shape[0]
    return {
        "global_rot": matrix_to_axis_angle(rot6d_to_matrix(raw["global_rot"])),
        "joint_rot": matrix_to_axis_angle(rot6d_to_matrix(raw["joint_rot"].reshape(B, J - 1, 6))),
        "betas": raw["betas"], "trans": raw["trans"], "fov": raw["fov"][:, 0],
        "cam_rot": rot6d_to_matrix(raw["cam_rot"][:, :6]), "cam_trans": raw["cam_trans"],
    }


def pose(m, preds):
    """Posed vertices and keypoints of decoded predictions (trans included)."""
    theta = torch.cat([preds["global_rot"][:, None], preds["joint_rot"]], 1)
    return smil.smil_forward(m, preds["betas"], theta, trans=preds["trans"])


def project(preds, points, H, W):
    """Keypoints through each sample's predicted camera → (y, x) / (H, W), clipped to ±10."""
    view = smil.to_view(points, preds["cam_rot"], preds["cam_trans"][:, None])
    yx = smil.ndc_to_yx(smil.to_ndc(view, preds["fov"][:, None], eps=1e-4), H, W)
    yx = yx / torch.tensor([H, W], dtype=yx.dtype, device=yx.device)
    return torch.nan_to_num(torch.clamp(yx, -10.0, 10.0))


def loss(m, preds, batch, weights, res):
    """The single-view loss: MSEs of the rotations' axis-angles (the joints'
    as the visible joints' mean Frobenius distance of their matrices), betas
    and trans; the visible keypoints' 2D MSE where a sample has ≥ 5 of them;
    the joint-angle regularizer."""
    jr, tg = preds["joint_rot"], batch
    total = weights["global_rot"] * ((preds["global_rot"] - tg["global_rot"]) ** 2).mean()
    ss = ((axis_angle_to_matrix(jr) - axis_angle_to_matrix(tg["joint_rot"])) ** 2).sum((-2, -1))
    pos = ss > 0
    per_joint = torch.where(pos, torch.sqrt(torch.where(pos, ss, torch.ones_like(ss))), 0.0)
    jvis = tg["kp_visibility"][:, 1:]
    total = total + weights["joint_rot"] * (per_joint * jvis).sum() / torch.clamp_min(jvis.sum(), 1e-8)
    total = total + weights["betas"] * ((preds["betas"] - tg["betas"]) ** 2).mean()
    total = total + weights["trans"] * ((preds["trans"] - tg["trans"]) ** 2).mean()
    _, joints = pose(m, preds)
    vis = tg["kp_visibility"]
    valid = ((vis > 0).sum(-1) >= 5).to(vis.dtype)
    mask = (vis[..., None] * valid[:, None, None]).expand(-1, -1, 2)
    d = (project(preds, joints, res, res) - tg["keypoints_2d"]) ** 2
    total = total + weights["keypoint_2d"] * (d * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return total + weights["joint_angle_regularization"] * (jr ** 2).mean()


def forward(w, images, cfg, J, B, train, conv=F.conv2d):
    """Decoded predictions of NHWC [0, 1] images."""
    return decode(head(w, backbone(w, images, train, conv), cfg, J, B), J)


def train_steps(w, m, batches, cfg, J, B, weights, res, lr, betas=(0.9, 0.999), eps=1e-8,
                conv=F.conv2d):
    """Adam steps on ``batches`` from weights ``w``: (losses, the first
    gradient by parameter, the parameters after the steps)."""
    names = [k for k, _, kind in layout(cfg, J, B) if not kind.startswith(("stat", "count"))]
    p = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    sq = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        total = loss(m, forward(p, batch["image"], cfg, J, B, True, conv), batch, weights, res)
        grads = torch.autograd.grad(total, [p[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            if first is None:
                first = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                mom[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                sq[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (sq[k] / (1 - betas[1] ** t)).sqrt() + eps
                p[k] -= lr * (mom[k] / (1 - betas[0] ** t)) / denom
    return losses, first, {k: v.detach() for k, v in p.items()}
