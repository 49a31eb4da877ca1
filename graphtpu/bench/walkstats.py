"""Random-walk statistical diagnostics.

Batched device equivalent of the reference's random-walk assumption tests
(``simrank/random_test/RandomWalkTest.java:19-40``): exact vs Monte-Carlo
path probabilities (``getPathPro``/``samplePathPro`` ``:87-131``), the
double-walk meeting probability (``samplePathProDoubleWalk`` ``:142-167``),
and the single-pair MC SimRank probe (``testPairSimRank`` ``:175-210``).

Where the reference loops ``times x SAMPLE`` walks one hop at a time on
the JVM, these run the whole sample batch as one ``[S, L]`` walk tensor
per call (one scan over steps), so a 100k-sample probe is a single device
execution.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph
from graphtpu.walks.walker import uniform_walks


def random_path(
    g: Graph, src: int, length: int, key: Optional[jax.Array] = None
) -> np.ndarray:
    """One uniform random path [length+1] from src (``randomPath :38-47``);
    dead ends leave -1 tails."""
    if key is None:
        key = jax.random.key(0)
    w = uniform_walks(g, jnp.asarray([src], jnp.int32), length, key)
    return np.asarray(w[0])


def path_probability(g: Graph, path: np.ndarray) -> float:
    """Exact forward probability of a specific path: prod 1/deg(path[i])
    over all non-terminal positions (``getPathPro :87-93``)."""
    deg = np.asarray(g.deg)
    d = deg[np.asarray(path[:-1], np.int64)]
    if (d == 0).any():
        return 0.0
    return float(np.prod(1.0 / d))


def sample_path_probability(
    g: Graph, path: np.ndarray, samples: int, key: Optional[jax.Array] = None
) -> float:
    """MC estimate of path_probability: fraction of ``samples`` uniform
    walks from path[0] that follow the path exactly
    (``samplePathPro :113-131``)."""
    if key is None:
        key = jax.random.key(0)
    path = jnp.asarray(path, jnp.int32)
    starts = jnp.full((samples,), path[0], jnp.int32)
    walks = uniform_walks(g, starts, int(path.shape[0]) - 1, key)
    hit = jnp.all(walks == path[None, :], axis=1)
    return float(hit.mean())


def double_meet_probability(g: Graph, path: np.ndarray) -> float:
    """Exact probability that two walkers starting at path[0] and path[-1]
    trace the path's two halves and meet at its midpoint
    (the "real double random suffer pro", ``testPathPro :76-80``)."""
    deg = np.asarray(g.deg, np.float64)
    n = len(path)
    # the reference asserts an even hop count (randPath's pathLen % 2 == 0);
    # with an even node count the two halves would straddle the midpoint and
    # the value would no longer be a meeting probability
    assert n % 2 == 1, "path must have an even number of hops (odd node count)"
    mid = (n - 1) // 2
    p = 1.0
    for i in range(mid):
        d1, d2 = deg[path[i]], deg[path[n - 1 - i]]
        if d1 == 0 or d2 == 0:
            return 0.0
        p /= d1 * d2
    return float(p)


def sample_double_meet_probability(
    g: Graph, path: np.ndarray, samples: int, key: Optional[jax.Array] = None
) -> float:
    """MC estimate of double_meet_probability: two independent walker
    batches from both endpoints, counting joint traces that meet at the
    midpoint (``samplePathProDoubleWalk :142-167``)."""
    if key is None:
        key = jax.random.key(0)
    k1, k2 = jax.random.split(key)
    path = jnp.asarray(path, jnp.int32)
    n = int(path.shape[0])
    assert n % 2 == 1, "path must have an even number of hops (odd node count)"
    mid = (n - 1) // 2
    heads = uniform_walks(
        g, jnp.full((samples,), path[0], jnp.int32), mid, k1
    )
    tails = uniform_walks(
        g, jnp.full((samples,), path[n - 1], jnp.int32), mid, k2
    )
    ok_h = jnp.all(heads == path[None, : mid + 1], axis=1)
    ok_t = jnp.all(tails == path[None, ::-1][:, : mid + 1], axis=1)
    return float((ok_h & ok_t).mean())


@partial(jax.jit, static_argnames=("c", "step", "samples"))
def _pair_estimate(g, src, dst, c: float, step: int, samples: int, key):
    from graphtpu.simrank.uniwalk import _first_meet_mask

    starts = jnp.full((samples,), src, jnp.int32)
    walks = uniform_walks(g, starts, 2 * step, key)      # [S, 2*step+1]
    total = jnp.float32(0.0)
    for i in range(1, step + 1):
        target = walks[:, 2 * i]
        ok = (target == dst) & _first_meet_mask(walks, i)
        inter_deg = g.deg[jnp.maximum(walks[:, i], 0)].astype(jnp.float32)
        dst_deg = jnp.maximum(g.deg[dst], 1).astype(jnp.float32)
        total += jnp.sum(
            jnp.where(ok, (c**i) * inter_deg / dst_deg, 0.0)
        )
    return total / samples


def pair_simrank_mc(
    g: Graph,
    src: int,
    dst: int,
    c: float = 0.6,
    step: int = 3,
    samples: int = 40000,
    times: int = 30,
    key: Optional[jax.Array] = None,
) -> Tuple[float, float]:
    """Single-pair UniWalk SimRank probe: mean and std over ``times``
    independent ``samples``-walk estimates (``testPairSimRank :175-210``;
    reference defaults times=30, SAMPLE=40000)."""
    if src == dst:
        raise ValueError("same nodes!")  # reference prints and bails
    if key is None:
        key = jax.random.key(0)
    ests = [
        float(
            _pair_estimate(
                g, src, dst, c, step, samples, jax.random.fold_in(key, t)
            )
        )
        for t in range(times)
    ]
    return float(np.mean(ests)), float(np.std(ests))
