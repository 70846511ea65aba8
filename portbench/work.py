"""The yardstick's arithmetic: published peaks and the operations, FLOPs and
bytes each cell's work needs, from the configuration's published shapes and
the benchmark's own counts, never from the program's counters.

Peaks: NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W
limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them, 3.35 TB/s of HBM3.

A (pixel, face) pair of the soft silhouette costs 76 float32 operations
forward and 93 backward (an FMA counts 2, exp and log1p 1 each): the
distance to three edges 3 × 18, the inside test and sign 14, the softplus
5, the validity product and the sum 3; backward the signed distance again
68, the sigmoid 4, the weight 5, the edge pick 5 and six gradients 11.
A multiply-add is 2 FLOPs everywhere."""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
FWD_OPS_PER_PAIR = 76
BWD_OPS_PER_PAIR = 93

TILE_PIX = 1024
GROUP = 8


def raster_least_s(pairs: int, frames: int, faces: int, tiles: int, k_sub: int) -> float:
    """The least seconds of the capped raster's forward and backward over
    ``frames``: each kernel's operations over the float32 peak or its bytes
    (face rows of 8 floats, the work lists and counts, the S or dS tiles,
    the face gradients, each read or written once) over HBM's, the larger."""
    f8 = -(-faces // GROUP) * GROUP
    rows, lists, tile_px = f8 * 8 * 4, tiles * (k_sub + 1) * 4, tiles * TILE_PIX * 4
    fwd = max(pairs * FWD_OPS_PER_PAIR / PEAK_FP32, frames * (rows + lists + tile_px) / PEAK_HBM)
    bwd = max(pairs * BWD_OPS_PER_PAIR / PEAK_FP32,
              frames * (2 * rows + lists + tile_px) / PEAK_HBM)
    return fwd + bwd


def smil_flops(V: int, J: int, B: int) -> int:
    """One frame's SMIL forward: shape and pose blend shapes, the joint
    regression from the template and from the posed vertices, the chain's
    J − 1 4×4 products and rest-pose offsets, skinning weights times the
    3×4 transforms and their application, and the trans."""
    blend = 2 * B * 3 * V + 2 * 9 * (J - 1) * 3 * V
    regress = 2 * (2 * V * J * 3)
    chain = (J - 1) * 2 * 64 + J * 2 * 9
    skin = 2 * V * J * 12 + V * (2 * 9 + 3) + 3 * V
    return blend + regress + chain + skin


def projection_flops(points: int) -> int:
    """World → view (3×3 and a shift), the perspective divide and the
    screen mapping, a point."""
    return points * (2 * 9 + 3 + 6 + 4)


def fit_step_flops(frames: int, V: int, J: int, B: int, pairs: int) -> float:
    """One fitter step: the SMIL forward and the projections of vertices and
    joints forward and backward (3 × forward) and the raster's pairs."""
    geometry = frames * (smil_flops(V, J, B) + projection_flops(V + J))
    return 3 * geometry + pairs * (FWD_OPS_PER_PAIR + BWD_OPS_PER_PAIR)


def conv_flops(h: int, w: int, cin: int, cout: int, k: int, stride: int, pad: int):
    """(FLOPs, output height, output width) of one convolution."""
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return 2 * ho * wo * cout * cin * k * k, ho, wo


def resnet50_flops(res: int) -> tuple:
    """(FLOPs, final map side, channels) of ResNet-50's convolutions at
    ``res``² (torchvision's layout, stride on the 3×3; no classifier)."""
    total, h, _ = conv_flops(res, res, 3, 64, 7, 2, 3)
    h = (h + 2 - 3) // 2 + 1                                     # max pool 3, stride 2, pad 1
    cin = 64
    for i, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
        for b in range(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            f1, _, _ = conv_flops(h, h, cin, planes, 1, 1, 0)
            f2, ho, _ = conv_flops(h, h, planes, planes, 3, stride, 1)
            f3, _, _ = conv_flops(ho, ho, planes, planes * 4, 1, 1, 0)
            total += f1 + f2 + f3
            if b == 0:
                total += conv_flops(h, h, cin, planes * 4, 1, stride, 0)[0]
            h, cin = ho, planes * 4
    return total, h, cin


def ief_head_flops(tokens: int, token_dim: int, dim: int, depth: int, mlp: int,
                   out_dim: int, iters: int) -> int:
    """The IEF decoder an image: the memory projection once; each iteration
    the estimate embedding and, a layer, the query token's self-attention,
    its cross-attention (the memory's keys and values projected anew) and
    the MLP; the output heads."""
    memory = 2 * tokens * token_dim * dim
    self_att = 4 * 2 * dim * dim + 2 * 2 * dim
    cross = 2 * 2 * dim * dim + 2 * 2 * tokens * dim * dim + 2 * 2 * tokens * dim
    layer = self_att + cross + 2 * 2 * dim * mlp
    return memory + iters * (2 * out_dim * dim + depth * layer + 2 * dim * out_dim)


def regressor_image_flops(res: int, head: dict, V: int, J: int, B: int) -> float:
    """One image's forward: backbone, head, the SMIL forward and the
    keypoints' projection."""
    backbone, side, channels = resnet50_flops(res)
    out_dim = 6 + 6 * (J - 1) + B + 3 + 1 + 9 + 3
    head_f = ief_head_flops(side * side, channels, head["dim"], head["depth"],
                            head["mlp_ratio"] * head["dim"], out_dim, head["iters"])
    return backbone + head_f + smil_flops(V, J, B) + projection_flops(J)
