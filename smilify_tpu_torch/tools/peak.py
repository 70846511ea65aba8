"""K5, the FP32 FMA peak probe: kernel wrapper and plain version.

The JAX package measures its chip's vector-unit peak with a Pallas kernel
(``tools/bench_all.py::measure_vpu_peak_gflops``) and uses it as the
denominator of the raster's roofline share. The port's counterpart is the
CUDA kernel ``fma_peak_kernel`` (``csrc/peak.cu``), the same function
element for element: 32 FMA streams a_i = x·(1 + 0.1·i), 128 rounds of
a ← a·0.999999 + 1e-9, summed in stream order. :func:`fma_peak` launches it
for a CUDA tensor (a build or launch failure raises) and runs
:func:`fma_peak_plain` for a CPU tensor; it counts its launches in the
counter ``peak.fma.launches`` (:mod:`smilify_tpu_torch.utils.monitoring`,
while recording).
"""

from __future__ import annotations

import torch

from smilify_tpu_torch.render import _kernels
from smilify_tpu_torch.utils import monitoring

STREAMS = 32
ROUNDS = 128
MUL = 0.999999
ADD = 1e-9
# the JAX probe's input: grid 64 × block (32, 1024)
SHAPE = (2048, 1024)


def flops(n_elements: int) -> int:
    """FP32 operations the probe is credited with, as the JAX package counts
    them: 2 per FMA, 32 streams × 128 rounds an element (the 32 set-up
    multiplies and 31 adds of the final sum are not counted)."""
    return STREAMS * 2 * ROUNDS * n_elements


def fma_peak_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe's function as PyTorch ops, rounded as the kernel rounds:
    each round's multiply and add are done in float64 (the product of two
    float32 values is exact there) and rounded to float32 once, as one FMA
    is."""
    mul, add = (float(torch.tensor(c, dtype=torch.float32)) for c in (MUL, ADD))
    a = torch.stack([x * (1.0 + 0.1 * i) for i in range(STREAMS)])
    for _ in range(ROUNDS):
        a = (a.double() * mul + add).float()
    acc = a[0]
    for i in range(1, STREAMS):
        acc = acc + a[i]
    return acc


def fma_peak(x: torch.Tensor) -> torch.Tensor:
    """The probe on ``x`` (float32): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fma_peak_plain(x)
    _kernels.check(x, "x", torch.float32, x.shape)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernels.launch("smil_fma_peak", x.data_ptr(), out.data_ptr(), x.numel(),
                        _kernels.stream())
    monitoring.count("peak.fma.launches")
    return out
