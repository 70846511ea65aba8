"""The share of a train step in which the device ran nothing: the traced
steps' device busy seconds against the untraced window's seconds a step
(``portbench/readings.py::idle_pct``; the cards' busy seconds averaged)."""

from portbench.readings import idle_pct


def read(obs):
    return idle_pct(obs)
