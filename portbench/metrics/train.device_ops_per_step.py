"""Device operations (kernels, copies, fills) a train step in rank 0's trace."""

from portbench.readings import ops_per_step


def read(obs):
    return ops_per_step(obs)
