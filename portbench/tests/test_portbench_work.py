"""The yardstick's counts against hand counts at tiny sizes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs, work
from portbench.reference import raster
from portbench.reference import regressor as ref_reg


def test_conv_flops_by_hand():
    # 3×3 stride 1 pad 1 on 8×8, 4 → 5 channels: 64 outputs × 5 × (4 × 9) MACs
    assert work.conv_flops(8, 8, 4, 5, 3, 1, 1) == (2 * 64 * 5 * 36, 8, 8)
    assert work.conv_flops(8, 8, 4, 5, 1, 2, 0)[1:] == (4, 4)


@pytest.mark.parametrize("res", [32, 64])
def test_resnet50_flops_match_the_counted_convolutions(res):
    head = {"dim": 16, "depth": 1, "heads": 2, "iters": 1, "mlp_ratio": 4}
    w = inputs.regressor_weights(head, 4, 2, seed=0, device="cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref_reg.backbone(w, torch.rand(1, res, res, 3), train=False)
    assert work.resnet50_flops(res)[0] == counter.get_total_flops()


def test_resnet50_at_224_is_the_published_count():
    # He et al.: 3.8-4.1 GMACs with the classifier (2048 × 1000)
    flops, side, channels = work.resnet50_flops(224)
    assert (side, channels) == (7, 2048)
    assert abs(flops / 2 + 2048 * 1000 - 4.09e9) / 4.09e9 < 0.01


def test_ief_head_flops_match_the_counted_matmuls():
    head = {"dim": 16, "depth": 2, "heads": 2, "iters": 3, "mlp_ratio": 4}
    J, B, tokens = 4, 2, 9
    w = inputs.regressor_weights(head, J, B, seed=0, device="cpu")
    w["head.memory_proj.weight"] = torch.randn(16, 32)
    out_dim = sum(d for _, d in ref_reg.group_dims(J, B))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref_reg.head(w, torch.randn(1, tokens, 32), head, J, B)
    assert work.ief_head_flops(tokens, 32, 16, 2, 64, out_dim, 3) == counter.get_total_flops()


def _one_triangle(x0, y0, size=0.05):
    tri = torch.tensor([[[x0, y0], [x0 + size, y0], [x0, y0 + size]]])[None]    # (1, 1, 3, 2)
    return tri, torch.full((1, 1, 3), 2.0)


def test_pairs_of_one_face_inside_one_tile():
    # a small face at the middle of the first tile of a 64² image (NDC +x is
    # left, +y up: tile 0 is the top-left, x ∈ [1 − 1/32, 1 − 63/32])
    tri, z = _one_triangle(0.45, 0.45, 0.02)
    assert raster.pairs(tri, z, 64, 64) == 1 * 8 * 1024


def test_pairs_of_a_face_across_four_tiles():
    tri, z = _one_triangle(-0.01, -0.01, 0.02)         # at the image centre
    assert raster.pairs(tri, z, 64, 64) == 4 * 8 * 1024


def test_pairs_under_the_cap_keep_the_nearest_subgroups():
    # three subgroups (24 faces) over the same tile at depths 3, 1, 2: a cap of
    # two subgroups keeps the two nearest
    tri, z = _one_triangle(0.45, 0.45, 0.02)
    tri = tri.expand(1, 24, 3, 2).clone()
    z = torch.cat([torch.full((1, 8, 3), d) for d in (3.0, 1.0, 2.0)], 1)
    idx, keep = raster.candidates(tri, z, 64, 64, k_sub=2)
    assert keep[0, 0].tolist() == [True, True] and sorted(idx[0, 0].tolist()) == [1, 2]
    assert raster.pairs(tri, z, 64, 64, k_sub=2) == 2 * 8 * 1024
    assert raster.pairs(tri, z, 64, 64) == 3 * 8 * 1024


def test_raster_least_time_is_bound_by_operations():
    pairs = 20_000_000
    least = work.raster_least_s(pairs, 1, 5832, 256, 100)
    assert least == pytest.approx(pairs * (76 + 93) / 67e12)


def test_fit_step_flops_by_hand():
    V, J, B = 9, 3, 2
    smil = work.smil_flops(V, J, B)
    assert smil == (2 * B * 3 * V + 2 * 9 * (J - 1) * 3 * V + 2 * (2 * V * J * 3)
                    + (J - 1) * 128 + J * 18 + 2 * V * J * 12 + V * 21 + 3 * V)
    assert work.fit_step_flops(2, V, J, B, 100) == (
        3 * 2 * (smil + work.projection_flops(V + J)) + 100 * 169)
