"""Walker alias method — host-side parity utility.

The reference samples every hop through alias tables
(``node2vec/src/node2vec.py:116-160``).  Our device kernels use CSR bisection
and rejection sampling instead (alias construction is inherently sequential
per distribution and per-edge tables are the memory wall), but we keep a
numpy implementation as the statistical oracle and for host-side tooling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def alias_setup(probs) -> Tuple[np.ndarray, np.ndarray]:
    """Build (J, q) alias tables for a normalised distribution."""
    probs = np.asarray(probs, dtype=np.float64)
    k = len(probs)
    q = probs * k
    J = np.zeros(k, dtype=np.int64)
    smaller = [i for i in range(k) if q[i] < 1.0]
    larger = [i for i in range(k) if q[i] >= 1.0]
    while smaller and larger:
        small = smaller.pop()
        large = larger.pop()
        J[small] = large
        q[large] = q[large] + q[small] - 1.0
        (smaller if q[large] < 1.0 else larger).append(large)
    return J, q


def alias_draw(J: np.ndarray, q: np.ndarray, rng: np.random.Generator) -> int:
    k = len(J)
    kk = int(np.floor(rng.random() * k))
    return kk if rng.random() < q[kk] else int(J[kk])


def alias_sample(
    J: np.ndarray, q: np.ndarray, rng: np.random.Generator, n: int
) -> np.ndarray:
    """Vectorised n draws."""
    k = len(J)
    kk = rng.integers(0, k, size=n)
    take_alias = rng.random(n) >= q[kk]
    return np.where(take_alias, J[kk], kk)
