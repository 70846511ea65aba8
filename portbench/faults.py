"""Faults planted under the timed path, to show that the check catches
them. Each driver lists the faults its cells can have in ``FAULTS``
({name: a function returning a context manager that patches the program
while it is open}); the benchmark's runs plant none, ``calibrate.py`` reads
them on the card and ``tests/test_portbench_faults.py`` sees ``correct``
come out false. The kinds:

* ``unchanged``: every step leaves the parameters as they were;
* ``half_batch``: the loss sees only the first half of the batch (of the
  frames, for a fit), the mean taken over it;
* ``no_exchange``: a data-parallel step without its exchange (no gradient
  all-reduce, each rank's BatchNorm on its own rows);
* ``altered``: one answer changed where it is made."""

from __future__ import annotations

import contextlib


def kinds(driver: str) -> tuple:
    from portbench import harness

    return tuple(harness.driver(driver).FAULTS)


def plant(driver: str, fault: str):
    """The context manager of ``fault`` for a cell of ``driver``."""
    from portbench import harness

    faults = harness.driver(driver).FAULTS
    if fault not in faults:
        raise ValueError(f"{driver} cannot have the fault {fault!r}")
    return faults[fault]()


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` set to ``value`` while open."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)
