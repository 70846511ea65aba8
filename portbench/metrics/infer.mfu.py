"""Inference's share of the card's bf16 peak (989 TFLOP/s): an image's
forward FLOPs (ResNet-50, the IEF head, the SMIL forward) times the
untraced window's images a second."""

from portbench.readings import mfu


def read(obs):
    return mfu(obs, "item")
