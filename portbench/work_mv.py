"""The multi-view regressor's FLOPs, from the configuration's published
widths (``work.py`` holds the peaks and the other cells' counts). A
multiply-add is 2 FLOPs; softmax, norms and activations are not counted."""

from __future__ import annotations

from portbench import work


def vit_flops(res: int, depth: int, dim: int, mlp: int, patch: int) -> int:
    """One image's ViT forward: the patch embedding, then each block's
    fused qkv, the attention's scores and weighted sum over every token
    (the CLS token's included), the output projection and the MLP."""
    n = (res // patch) ** 2 + 1
    embed = 2 * (n - 1) * dim * 3 * patch * patch
    block = 2 * n * dim * 3 * dim + 2 * 2 * n * n * dim + 2 * n * dim * dim + 2 * 2 * n * dim * mlp
    return embed + depth * block


def fusion_flops(views: int, dim: int, width: int, layers: int) -> int:
    """A frame's cross-view fusion: the projection to the decoder's width,
    then a layer's self-attention over the views and its 4× MLP."""
    attend = 4 * 2 * views * width * width + 2 * 2 * views * views * width
    return 2 * views * dim * width + layers * (attend + 2 * 2 * views * width * 4 * width)


def camera_head_flops(views: int, dim: int, width: int, hidden: int) -> int:
    """A frame's camera head: two hidden layers and the 10 outputs a view."""
    return views * (2 * (2 * dim + width) * hidden + 2 * hidden * hidden + 2 * hidden * 10)


def view_image_flops(cfg: dict) -> float:
    """One view image's share of a frame's forward: its ViT, and a
    ``views``-th of the IEF decoder over every view's tokens (the memory's
    projection once, its keys and values in each layer of each iteration),
    the fusion, the camera head, the SMIL forward and the joints'
    projection through every view."""
    v, h, m = cfg["vit"], cfg["head"], cfg["model"]
    V, res, J, B = cfg["views"], cfg["image_size"], m["J"], m["B"]
    tokens = V * (res // v["patch"]) ** 2
    out_dim = 6 * J + B + 3
    frame = (work.ief_head_flops(tokens, v["dim"], h["dim"], h["depth"], h["mlp"], out_dim,
                                 h["iters"])
             + fusion_flops(V, v["dim"], h["dim"], cfg["fusion"]["layers"])
             + camera_head_flops(V, v["dim"], h["dim"], cfg["camera_hidden"])
             + work.smil_flops(m["V_side"] ** 2, J, B) + work.projection_flops(V * J))
    return vit_flops(res, v["depth"], v["dim"], v["mlp"], v["patch"]) + frame / V
