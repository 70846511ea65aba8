"""The capped raster's share of its roofline: the least time of the pairs
the z-cap admits (76 + 93 float32 operations a pair against 67 TFLOP/s, or
the bytes against 3.35 TB/s) over the device time of the work-list
kernels (K3 ``worklist_fwd_kernel``, K4 ``worklist_bwd_kernel``) a step."""

from portbench.readings import device_ms_per_step


def read(obs):
    ms = device_ms_per_step(obs, "worklist_fwd_kernel", "worklist_bwd_kernel")
    if not ms or "work" not in obs:
        return None
    return 100.0 * obs["work"]["raster_least_s_per_step"] * 1e3 / ms
