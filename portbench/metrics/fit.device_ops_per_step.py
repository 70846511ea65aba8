"""Device operations (kernels, copies, fills) a fitter step in the trace."""

from portbench.readings import ops_per_step


def read(obs):
    return ops_per_step(obs)
