"""Multi-stage optimization schedule — the OPT_WEIGHTS table.

Values match the reference ``config.py:64-74``: rows are
[joint, sil_reproj, betas, pose, limit, splay, temporal, iters, lr] and columns
are the four stages (stage 0 aligns camera/trans on torso joints only).

A copy of ``smilify_tpu/fitter/stages.py``: the port keeps its own copy of this
JAX-free module so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional


class StageWeights(NamedTuple):
    w_j2d: float
    w_reproj: float
    w_betas: float
    w_pose: float
    w_limit: float
    w_splay: float
    w_temp: float
    num_iters: int
    lr: float


# reference config.py OPT_WEIGHTS, transposed to per-stage records
OPT_WEIGHTS: List[StageWeights] = [
    StageWeights(25.0, 0.0, 0.0, 0.0, 0.0, 0.0, 500.0, 600, 9e-2),
    StageWeights(10.0, 500.0, 1.0, 1.0, 100.0, 0.1, 100.0, 400, 5e-3),
    StageWeights(7.5, 1000.0, 1.0, 1.0, 100.0, 0.1, 100.0, 600, 5e-4),
    StageWeights(5.0, 1000.0, 1.0, 1.0, 100.0, 0.1, 100.0, 600, 2e-4),
]


def test_schedule(num_iters: int = 10, max_stages: Optional[int] = None) -> List[StageWeights]:
    """The reference test override (tests/config_test.py): 10 iters per stage.

    ``max_stages`` truncates the schedule (CI keeps the CPU wall time bounded:
    each distinct stage is a separate XLA compile of the fused step)."""
    stages = [s._replace(num_iters=num_iters) for s in OPT_WEIGHTS]
    return stages[:max_stages] if max_stages else stages
