"""Map-style datasets for the batchers' tests, at module level so that the
spawn workers of ``iterate_batches(worker_mode="process")`` can unpickle
them without importing a test module (and JAX with it). Pytest does not
collect this file (its name does not start with ``test_``)."""

import numpy as np


class IndexDataset:
    """Sample i is ``{"x": [i, i]}``; the indices in ``bad`` raise."""

    def __init__(self, n, bad=()):
        self.n, self.bad = n, tuple(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise ValueError("corrupt sample")
        return {"x": np.full((2,), i, np.float32)}
