"""The share of a batch of inference in which the device ran nothing: the traced
steps' device busy seconds against the untraced window's seconds a step
(``portbench/readings.py::idle_pct``)."""

from portbench.readings import idle_pct


def read(obs):
    return idle_pct(obs)
