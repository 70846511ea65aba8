"""The train step's share of the cards' bf16 peak (989 TFLOP/s a card):
3 × an image's forward FLOPs (ResNet-50's convolutions, the IEF head, the
SMIL forward and projection, at the published widths and 224²) times the
untraced window's images a second, over the cell's cards."""

from portbench.readings import mfu


def read(obs):
    return mfu(obs, "item")
