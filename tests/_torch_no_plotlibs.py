"""What the port's plot, polygon and YAML tests share: the card's machine
without matplotlib or PyYAML, and matplotlib's polygon mask as the reference.

``block_plot_libraries(monkeypatch)`` drops matplotlib, mpl_toolkits and yaml
from ``sys.modules`` and makes importing them fail until the test ends, so
the port's side of a test runs as on a host without them. ``mpl_mask`` is
the mask ``Path.contains_points`` draws (matplotlib imported when called).
Pytest does not collect this file (its name does not start with ``test_``).
"""

import sys

import numpy as np

BLOCKED = ("matplotlib", "mpl_toolkits", "yaml")


def block_plot_libraries(monkeypatch) -> None:
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            monkeypatch.delitem(sys.modules, name)
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)


def mpl_mask(polygons, height, width):
    """(height, width) bool: pixel centres inside any of ``polygons`` (flat
    or (N, 2) vertex lists), as matplotlib's ``Path.contains_points``."""
    from matplotlib.path import Path

    yy, xx = np.mgrid[0:height, 0:width]
    pix = np.stack([xx.ravel(), yy.ravel()], axis=1)
    out = np.zeros((height, width), bool)
    for poly in polygons:
        out |= Path(np.asarray(poly).reshape(-1, 2)).contains_points(pix).reshape(height, width)
    return out
