"""The fitter step's share of the card's float32 peak (67 TFLOP/s): the
raster's pairs × (76 + 93) plus the SMIL forward and projections × 3, a
step, times the untraced window's steps a second."""

from portbench.readings import mfu


def read(obs):
    return mfu(obs, "step")
