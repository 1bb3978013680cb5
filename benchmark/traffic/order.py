"""The seeded order in which a pool's batches or chunks are served.

The pool's items come sorted by size.  Each pass serves every item once,
in an order where every run of `strata` consecutive items holds one item
of each stratum (the size order cut into `strata` equal runs), so that
any stretch of a window sees the pool's mix of sizes and not a seeded
draw of large or small ones."""

from __future__ import annotations

import numpy as np


def stratified(n: int, seed: int, tag: int, strata: int):
    """An endless sequence of indices 0..n-1, a new seeded order each
    pass."""
    rng = np.random.default_rng([seed, tag])
    groups = np.array_split(np.arange(n), min(strata, n))
    while True:
        perms = [rng.permutation(g) for g in groups]
        for r in range(max(len(g) for g in groups)):
            for j in rng.permutation(len(groups)):
                if r < len(perms[j]):
                    yield int(perms[j][r])
