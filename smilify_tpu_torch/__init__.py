"""smilify_tpu_torch — the PyTorch/CUDA port of ``smilify_tpu`` for NVIDIA Hopper.

The JAX package ``smilify_tpu`` stays beside this one as the reference; this
package imports nothing of it (nor JAX). Module names and layout mirror the
JAX package so each module's counterpart is easy to find:

core     : ModelSpec, rotations, linear blend skinning.
render   : FoV camera, soft-silhouette rasterizer (hand-written CUDA kernels
           for sm_90a, with plain PyTorch versions for CPU tensors).
fitter   : the 2D keypoint + silhouette optimization fitter, and 3D registration.
ops      : kNN, mesh sampling and losses, SDF.
data     : loaders, the HDF5 dataset schema, replicAnt/SLEAP inputs,
           augmentation, the synthetic multi-view generator.
models   : the regressors' backbones, IEF/MLP heads, single- and multi-view
           regressors, their decode and losses, and weight carrying.
train    : configs, checkpoints, staging, splits, the benchmark accumulator
           and the device-resident data cache.
cli      : the fitter, registration, data, inference and benchmark command
           lines.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when CUDA is absent, unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
