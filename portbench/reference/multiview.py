"""SMILify's multi-view regressor in plain PyTorch, as its published
defaults build it (``neuralSMIL/configs``: ``vit_large_patch16_224``, the
IEF transformer decoder, ``multi_view`` mode with ground-truth camera init):

* ViT-L/16 (Dosovitskiy et al. 2021, arXiv:2010.11929, timm's layout and
  names): a 16×16 patch embedding of ImageNet-normalized images, a CLS
  token and a learned position embedding, pre-norm blocks of fused-qkv
  softmax attention and an exact-erf GELU MLP, LayerNorm eps 1e-5, a final
  norm; the CLS token is a view's pooled feature, the patch tokens its
  memory;
* a learned embedding a canonical camera, added to each view's pooled
  feature and to its tokens;
* the cross-view fusion: a projection to the decoder's width and pre-norm
  blocks of self-attention over the views under the view mask (a masked
  key's logit at float32's most negative value, so a frame whose every
  view is masked attends uniformly) and a tanh-GELU MLP; the fused views'
  masked mean;
* the camera head, one MLP shared over the views (LayerNorm eps 1e-6,
  ReLU) on [pooled, fused mean, camera embedding], adding its fov, 6D
  rotation and translation to the ground-truth camera's (delta mode);
* the IEF decoder (``regressor.py``'s layers, here over every view's
  tokens and the body's parameter groups alone);
* the decode (6D → axis-angle; each view's 6D → matrix), the SMIL forward
  (``smil.py``), the projection of the joints through each predicted view
  camera;
* SMILify's multi-view loss: the body parameters' MSEs, each view camera's
  fov, rotation and translation MSEs over the present views, the visible
  keypoints' 2D MSE over the present views, the 3D keypoints' MSE, the DLT
  triangulation consistency (the ground-truth 2D keypoints triangulated
  through the predicted cameras by Tikhonov-damped normal equations,
  λ = 1e-4, against the predicted 3D joints) and the joint-angle
  regularizer;
* AdamW with optax's global-norm clip (``g · max / ‖g‖`` where ‖g‖ ≥ max,
  no epsilon) and two learning rates: the backbone's at the head's × its
  multiplier.

Departures from the published description: the view embeddings and the
camera head's output layers start from the benchmark's seeded draw, not
from zero; the SMIL body is the benchmark's procedural mesh (``smil.py``);
the ViT takes 224² images only (no position-embedding interpolation).

Everything runs in float32 (TF32 off). ``lin`` and ``conv`` replace the
ViT's linear layers and its patch embedding, which is how the control
computes them in a lower precision. Weights are a dict keyed by the port's
state-dict names (:func:`layout`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import regressor as ref_reg
from portbench.reference import smil

VIT_LN_EPS, LN_EPS = 1e-5, 1e-6
DAMPING = 1e-4                  # the DLT's Tikhonov λ
PROJECT_EPS = 1e-4              # |z| kept from 0 in the keypoints' projection
ZNEAR, ZFAR = 0.001, 1000.0
CV_TO_VIEW = (-1.0, -1.0, 1.0)  # OpenCV (x right, y down) → view space (x left, y up)


def body_dims(J: int, B: int):
    return (("global_rot", 6), ("joint_rot", 6 * (J - 1)), ("betas", B), ("trans", 3))


def layout(cfg: dict, J: int, B: int):
    """[(name, shape, kind)] of every parameter; kind says how
    :func:`portbench.inputs_mv.weights` fills it."""
    v, h, f = cfg["vit"], cfg["head"], cfg["fusion"]
    D, P, n = v["dim"], v["patch"], (cfg["image_size"] // v["patch"]) ** 2
    out = [("backbone.cls_token", (1, 1, D), "token"),
           ("backbone.pos_embed", (1, n + 1, D), "token"),
           ("backbone.patch_embed.proj.weight", (D, 3, P, P), "linear"),
           ("backbone.patch_embed.proj.bias", (D,), "zero")]

    def linear(name, n_out, n_in, kind="linear"):
        out.extend([(f"{name}.weight", (n_out, n_in), kind), (f"{name}.bias", (n_out,), "zero")])

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero")])

    for i in range(v["depth"]):
        pre = f"backbone.blocks.{i}"
        norm(f"{pre}.norm1", D)
        linear(f"{pre}.attn.qkv", 3 * D, D)
        linear(f"{pre}.attn.proj", D, D)
        norm(f"{pre}.norm2", D)
        linear(f"{pre}.mlp.fc1", v["mlp"], D)
        linear(f"{pre}.mlp.fc2", D, v["mlp"])
    norm("backbone.norm", D)
    out.append(("view_embeddings.weight", (cfg["canonical_cameras"], D), "embed"))
    E = h["dim"]
    linear("cross_view_fusion.Dense_0", E, D)
    for i in range(f["layers"]):
        pre = "cross_view_fusion"
        norm(f"{pre}.LayerNorm_{2 * i}", E)
        for proj in ("query", "key", "value", "out"):
            linear(f"{pre}.MultiHeadDotProductAttention_{i}.{proj}", E, E)
        norm(f"{pre}.LayerNorm_{2 * i + 1}", E)
        linear(f"{pre}.Dense_{2 * i + 1}", 4 * E, E)
        linear(f"{pre}.Dense_{2 * i + 2}", E, 4 * E)
    total = sum(d for _, d in body_dims(J, B))
    out.append(("body_head.init_estimate", (total,), "init_estimate"))
    linear("body_head.memory_proj", E, D)
    linear("body_head.estimate_embed", E, total)
    norm("body_head.estimate_norm", total)
    for i in range(h["depth"]):
        pre = f"body_head.layer_{i}"
        for a in range(2):
            norm(f"{pre}.LayerNorm_{a}", E)
            for proj in ("query", "key", "value", "out"):
                linear(f"{pre}.MultiHeadDotProductAttention_{a}.{proj}", E, E)
        norm(f"{pre}.LayerNorm_2", E)
        linear(f"{pre}.Dense_0", h["mlp"], E)
        linear(f"{pre}.Dense_1", E, h["mlp"])
    for name, d in body_dims(J, B):
        linear(f"body_head.head_{name}", d, E, "head")
    C = cfg["camera_hidden"]
    linear("camera_head.Dense_0", C, 2 * D + E)
    norm("camera_head.LayerNorm_0", C)
    linear("camera_head.Dense_1", C, C)
    norm("camera_head.LayerNorm_1", C)
    for i, d in ((2, 1), (3, 6), (4, 3)):
        linear(f"camera_head.Dense_{i}", d, C, "head")
    return out


def initial_estimate(J: int, B: int) -> torch.Tensor:
    """The IEF start: 6D identities, zero betas and trans."""
    ident6 = [1.0, 0, 0, 0, 1.0, 0]
    return torch.tensor(ident6 * J + [0.0] * (B + 3))


def _block(x, w, pre, heads, lin):
    N, L, D = x.shape
    y = F.layer_norm(x, (D,), w[f"{pre}.norm1.weight"], w[f"{pre}.norm1.bias"], VIT_LN_EPS)
    qkv = lin(y, w[f"{pre}.attn.qkv.weight"], w[f"{pre}.attn.qkv.bias"])
    q, k, v = qkv.view(N, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // heads), -1)
    y = (att @ v).transpose(1, 2).reshape(N, L, D)
    x = x + lin(y, w[f"{pre}.attn.proj.weight"], w[f"{pre}.attn.proj.bias"])
    y = F.layer_norm(x, (D,), w[f"{pre}.norm2.weight"], w[f"{pre}.norm2.bias"], VIT_LN_EPS)
    y = F.gelu(lin(y, w[f"{pre}.mlp.fc1.weight"], w[f"{pre}.mlp.fc1.bias"]))
    return x + lin(y, w[f"{pre}.mlp.fc2.weight"], w[f"{pre}.mlp.fc2.bias"])


def vit(w, images, cfg, lin=F.linear, conv=F.conv2d):
    """NHWC [0, 1] images (N, H, W, 3) → (pooled (N, D), tokens (N, T, D));
    each block is checkpointed under autograd (its activations recomputed
    in the backward)."""
    v = cfg["vit"]
    mean = torch.tensor(ref_reg.IMAGENET_MEAN, device=images.device)
    std = torch.tensor(ref_reg.IMAGENET_STD, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    x = conv(x, w["backbone.patch_embed.proj.weight"], w["backbone.patch_embed.proj.bias"],
             stride=v["patch"])
    N, D = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([w["backbone.cls_token"].expand(N, 1, D), x], 1) + w["backbone.pos_embed"]
    for i in range(v["depth"]):
        pre = f"backbone.blocks.{i}"
        # the weights ride as arguments, so the checkpoint sees what it must
        # recompute through
        names = [k for k in w if k.startswith(pre + ".")]
        run = (lambda x_, *vals, pre=pre, names=names:
               _block(x_, dict(zip(names, vals)), pre, v["heads"], lin))
        vals = [w[k] for k in names]
        x = (checkpoint(run, x, *vals, use_reentrant=False) if torch.is_grad_enabled()
             else run(x, *vals))
    x = F.layer_norm(x, (D,), w["backbone.norm.weight"], w["backbone.norm.bias"], VIT_LN_EPS)
    return x[:, 0], x[:, 1:]


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def _linear(w, name, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _masked_attend(w, name, x, mask, heads):
    """Self-attention over the views; ``mask`` (B, V) True = a key to attend."""
    B, L, D = x.shape
    h = D // heads
    q, k, v = (_linear(w, f"{name}.{p}", x).view(B, L, heads, h).transpose(1, 2)
               for p in ("query", "key", "value"))
    logits = q @ k.transpose(-1, -2) / math.sqrt(h)
    logits = torch.where(mask[:, None, None, :], logits, torch.finfo(logits.dtype).min)
    y = torch.softmax(logits, -1) @ v
    return _linear(w, f"{name}.out", y.transpose(1, 2).reshape(B, L, D))


def fusion(w, pooled, mask, cfg):
    """(B, V, D) view features → the fused views' masked mean (B, E)."""
    pre = "cross_view_fusion"
    x = _linear(w, f"{pre}.Dense_0", pooled)
    for i in range(cfg["fusion"]["layers"]):
        y = _ln(w, f"{pre}.LayerNorm_{2 * i}", x)
        x = x + _masked_attend(w, f"{pre}.MultiHeadDotProductAttention_{i}", y, mask,
                               cfg["fusion"]["heads"])
        y = _ln(w, f"{pre}.LayerNorm_{2 * i + 1}", x)
        y = F.gelu(_linear(w, f"{pre}.Dense_{2 * i + 1}", y), approximate="tanh")
        x = x + _linear(w, f"{pre}.Dense_{2 * i + 2}", y)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)


def ief(w, tokens, cfg, J, B):
    """The IEF decoder over ``tokens`` (B, T, D) → raw body groups {name: (B, d)}."""
    h = cfg["head"]
    memory = _linear(w, "body_head.memory_proj", tokens)
    est = w["body_head.init_estimate"].expand(tokens.shape[0], -1)
    dims = body_dims(J, B)
    for _ in range(h["iters"]):
        q = _linear(w, "body_head.estimate_embed", _ln(w, "body_head.estimate_norm", est))[:, None]
        for i in range(h["depth"]):
            pre = f"body_head.layer_{i}"
            y = _ln(w, f"{pre}.LayerNorm_0", q)
            q = q + ref_reg._attend(w, f"{pre}.MultiHeadDotProductAttention_0", y, y, h["heads"])
            y = _ln(w, f"{pre}.LayerNorm_1", q)
            q = q + ref_reg._attend(w, f"{pre}.MultiHeadDotProductAttention_1", y, memory,
                                    h["heads"])
            y = _ln(w, f"{pre}.LayerNorm_2", q)
            q = q + _linear(w, f"{pre}.Dense_1",
                            F.gelu(_linear(w, f"{pre}.Dense_0", y), approximate="tanh"))
        est = est + torch.cat([_linear(w, f"body_head.head_{n}", q[:, 0]) for n, _ in dims], -1)
    out, off = {}, 0
    for n, d in dims:
        out[n] = est[:, off:off + d]
        off += d
    return out


def view_cameras(batch, res):
    """The batch's OpenCV cameras in view-space convention: {view_cam_rot
    (B, V, 3, 3) row-vector world → view, view_cam_trans (B, V, 3),
    view_fov (B, V) degrees from fy}."""
    flip = torch.tensor(CV_TO_VIEW, device=batch["camera_extrinsics_R"].device)
    R = (flip[:, None] * batch["camera_extrinsics_R"]).transpose(-1, -2)
    fy = batch["camera_intrinsics"][..., 1, 1]
    fov = torch.rad2deg(2.0 * torch.atan2(torch.full_like(fy, res / 2.0), fy))
    return {"view_cam_rot": R, "view_cam_trans": batch["camera_extrinsics_t"] * flip,
            "view_fov": fov}


def camera_head(w, feats, embed, init):
    """Per-view (fov, 6D rotation, translation) added to the ground truth's."""
    x = torch.cat([feats, embed], -1)
    x = F.relu(_ln(w, "camera_head.LayerNorm_0", _linear(w, "camera_head.Dense_0", x)))
    x = F.relu(_ln(w, "camera_head.LayerNorm_1", _linear(w, "camera_head.Dense_1", x)))
    return (init["fov"] + _linear(w, "camera_head.Dense_2", x)[..., 0],
            init["rot6d"] + _linear(w, "camera_head.Dense_3", x),
            init["trans"] + _linear(w, "camera_head.Dense_4", x))


def forward(w, batch, cfg, J, B, lin=F.linear, conv=F.conv2d):
    """Decoded predictions of a batch: the body's parameters and each view's camera."""
    images = batch["images"]
    pooled, tokens = vit(w, images.reshape((-1,) + images.shape[2:]), cfg, lin, conv)
    return from_features(w, pooled, tokens, batch, cfg, J, B)


def from_features(w, pooled, tokens, batch, cfg, J, B):
    """:func:`forward` after the ViT, from its (N·V, D) pooled and (N·V, T, D)
    patch tokens: the view embeddings, the fusion, the IEF head, the camera
    head and the decode."""
    mask = batch["view_mask"].bool()
    N, V = mask.shape
    embed = w["view_embeddings.weight"][
        torch.clamp(batch["camera_indices"].long(), 0, cfg["canonical_cameras"] - 1)]
    pooled = pooled.reshape(N, V, -1) + embed
    tokens = tokens.reshape(N, V, tokens.shape[1], -1) + embed[:, :, None]
    fused = fusion(w, pooled, mask, cfg)
    raw = ief(w, tokens.reshape(N, -1, tokens.shape[-1]), cfg, J, B)
    gt = view_cameras(batch, cfg["image_size"])
    init = {"fov": gt["view_fov"], "rot6d": gt["view_cam_rot"][..., :2, :].reshape(N, V, 6),
            "trans": gt["view_cam_trans"]}
    fov, rot6d, trans = camera_head(
        w, torch.cat([pooled, fused[:, None].expand(N, V, fused.shape[-1])], -1), embed, init)
    return {
        "global_rot": ref_reg.matrix_to_axis_angle(ref_reg.rot6d_to_matrix(raw["global_rot"])),
        "joint_rot": ref_reg.matrix_to_axis_angle(
            ref_reg.rot6d_to_matrix(raw["joint_rot"].reshape(N, J - 1, 6))),
        "betas": raw["betas"], "trans": raw["trans"],
        "view_fov": fov, "view_cam_rot": ref_reg.rot6d_to_matrix(rot6d), "view_cam_trans": trans,
    }


def project_views(preds, points, res):
    """(B, K, 3) world points through each predicted view camera →
    normalized (B, V, K, 2) (y, x), clipped to ±10, NaN → 0."""
    view = smil.to_view(points[:, None], preds["view_cam_rot"], preds["view_cam_trans"][:, :, None])
    yx = smil.ndc_to_yx(smil.to_ndc(view, preds["view_fov"][..., None], eps=PROJECT_EPS), res, res)
    return torch.nan_to_num(torch.clamp(yx / res, -10.0, 10.0))


def clip_matrices(preds):
    """(B, V, 4, 4) column-vector world → clip matrices of the predicted cameras."""
    R, T, fov = preds["view_cam_rot"], preds["view_cam_trans"], preds["view_fov"]
    f = 1.0 / torch.tan(torch.deg2rad(fov) / 2.0)
    z, o = torch.zeros_like(fov), torch.ones_like(fov)
    a, b = ZFAR / (ZFAR - ZNEAR), -ZFAR * ZNEAR / (ZFAR - ZNEAR)
    K = torch.stack([torch.stack([f, z, z, z], -1), torch.stack([z, f, z, z], -1),
                     torch.stack([z, z, a * o, b * o], -1), torch.stack([z, z, o, z], -1)], -2)
    E = torch.cat([torch.cat([R.transpose(-1, -2), T[..., None]], -1),
                   torch.stack([z, z, z, o], -1)[..., None, :]], -2)
    return K @ E


def triangulate(ndc, P, weight):
    """Points from NDC (B, V, K, 2) seen through P (B, V, 4, 4) with
    weights (B, V, K): each view adds the rows x·P₄ − P₁ and y·P₄ − P₂ to
    a joint's system A [X 1]ᵀ = 0, solved for X from the damped normal
    equations (MᵀM + λI) X = −Mᵀ a₄ → (B, K, 3)."""
    rx = ndc[..., 0, None] * P[:, :, None, 3] - P[:, :, None, 0]        # (B, V, K, 4)
    ry = ndc[..., 1, None] * P[:, :, None, 3] - P[:, :, None, 1]
    A = torch.cat([rx, ry], 1) * torch.cat([weight, weight], 1)[..., None]   # (B, 2V, K, 4)
    M, a = A[..., :3], A[..., 3]
    lhs = torch.einsum("brki,brkj->bkij", M, M) + DAMPING * torch.eye(3, device=A.device)
    rhs = -torch.einsum("brki,brk->bki", M, a)
    return torch.linalg.solve(lhs, rhs[..., None])[..., 0]


def _mse(a, b, mask=None):
    d = (a - b) ** 2
    if mask is None:
        return d.mean()
    m = torch.broadcast_to(mask, d.shape)
    return (d * m).sum() / torch.clamp_min(m.sum(), 1.0)


def loss(m, preds, batch, weights, res):
    """SMILify's multi-view loss at ``weights`` (terms at weight 0 left out)."""
    vm = batch["view_mask"].float()
    vis = batch["keypoint_visibility"]
    kp = batch["keypoints_2d"].flip(-1) / res           # pixel (x, y) → normalized (y, x)
    gt = view_cameras(batch, res)
    terms = {
        "global_rot": lambda: _mse(preds["global_rot"], batch["global_rot"]),
        "joint_rot": lambda: _mse(preds["joint_rot"], batch["joint_rot"]),
        "betas": lambda: _mse(preds["betas"], batch["betas"]),
        "trans": lambda: _mse(preds["trans"], batch["trans"]),
        "fov": lambda: _mse(preds["view_fov"], gt["view_fov"], vm),
        "cam_rot": lambda: _mse(preds["view_cam_rot"], gt["view_cam_rot"], vm[..., None, None]),
        "cam_trans": lambda: _mse(preds["view_cam_trans"], gt["view_cam_trans"], vm[..., None]),
    }
    total = sum(weights[k] * f() for k, f in terms.items() if weights.get(k, 0) > 0)
    _, joints = ref_reg.pose(m, preds)
    if weights.get("keypoint_2d", 0) > 0:
        mask = (vm[..., None] * vis)[..., None]
        total = total + weights["keypoint_2d"] * _mse(project_views(preds, joints, res), kp, mask)
    if weights.get("keypoint_3d", 0) > 0:
        total = total + weights["keypoint_3d"] * _mse(joints, batch["keypoints_3d"])
    if weights.get("triangulation_consistency", 0) > 0:
        # normalized (y, x) → NDC (x, y): the screen mapping inverted
        ndc = torch.stack([(res - 1.0 - 2.0 * kp[..., 1] * res) / res,
                           (res - 1.0 - 2.0 * kp[..., 0] * res) / res], -1)
        tri = triangulate(ndc, clip_matrices(preds), vm[..., None] * vis)
        total = total + weights["triangulation_consistency"] * _mse(tri, joints)
    if weights.get("joint_angle_regularization", 0) > 0:
        total = total + weights["joint_angle_regularization"] * (preds["joint_rot"] ** 2).mean()
    return total


def train_steps(w, m, batches, cfg, J, B, weights, opt, lin=F.linear, conv=F.conv2d):
    """AdamW steps on ``batches`` from weights ``w`` (``opt``: lr,
    backbone_lr_multiplier, weight_decay, clip): (losses, the first clipped
    gradient by parameter, the parameters after the steps)."""
    names = [k for k, _, _ in layout(cfg, J, B)]
    p = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    sq = {k: torch.zeros_like(v) for k, v in p.items()}
    (b1, b2), eps, wd = (0.9, 0.999), 1e-8, opt["weight_decay"]
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        total = loss(m, forward(p, batch, cfg, J, B, lin, conv), batch, weights, cfg["image_size"])
        grads = torch.autograd.grad(total, [p[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < opt["clip"], 1.0, opt["clip"] / norm)
            grads = [g * scale for g in grads]
            if first is None:
                first = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                backbone = k.startswith("backbone.")
                lr = opt["lr"] * (opt["backbone_lr_multiplier"] if backbone else 1.0)
                p[k].mul_(1.0 - lr * wd)
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p[k] -= lr * (mom[k] / (1 - b1 ** t)) / ((sq[k] / (1 - b2 ** t)).sqrt() + eps)
    return losses, first, {k: v.detach() for k, v in p.items()}
