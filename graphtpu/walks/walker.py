"""First-order random walks, batched.

Batched form of the reference walk loops: the Java MC kernels step one
walker at a time through ``randNeighbor`` (``simrank/SingleRandomWalk.java:
53-72``); here a walk batch is an int32[B] frontier advanced by ``lax.scan``
with one CSR gather per step, producing the whole [B, L+1] walk tensor on
device.  Dead ends hold -1 from the first dead step onward (the reference
breaks the walk: ``node2vec.py:36-37``, ``Graph.java:69-73`` returns -1).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph
from graphtpu.kernels.sampling import (
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)


def uniform_walks(
    g: Graph,
    starts: jax.Array,
    num_steps: int,
    key: jax.Array,
    weighted: bool = False,
    sort_gather: bool = False,
) -> jax.Array:
    """int32[B, num_steps+1] walk tensor; column 0 is ``starts``.

    ``sort_gather``: sort the frontier by current node before each hop's
    CSR gathers and invert after — the row_ptr/deg/col reads become
    MONOTONIC in device memory (quasi-streaming) instead of random.  Unlike
    relabeling this helps even expander graphs whenever the batch is
    large relative to V·(page size): at the 10M flagship shape, 5M
    sorted walkers land ~16 slots apart in the 320 MB ``col`` array.
    Statistically identical walks (independent per-position draws),
    but NOT bitwise-equal to the unsorted mode — keep it off where
    trajectory-exact reproducibility across modes matters.
    """
    cumw = row_cumulative_weights(g) if weighted else None

    def sample(cur, k):
        if weighted:
            return weighted_neighbor(g, cumw, cur, k)
        return uniform_neighbor(g, cur, k)

    def step(carry, k):
        cur = carry
        if sort_gather:
            order = jnp.argsort(cur)
            inv = jnp.argsort(order)
            nxt = sample(cur[order], k)[inv]
        else:
            nxt = sample(cur, k)
        return nxt, nxt

    keys = jax.random.split(key, num_steps)
    _, cols = jax.lax.scan(step, starts.astype(jnp.int32), keys)
    return jnp.concatenate([starts[None, :], cols], axis=0).T


def walk_starts(
    g: Graph, num_walks: int, shuffle_key: Optional[jax.Array] = None
) -> jax.Array:
    """Start nodes: ``num_walks`` passes over every non-isolated node.

    The reference shuffles the node order each pass
    (``node2vec.py:41-59``); order only affects corpus layout, but we keep
    it so downstream batch statistics match.
    """
    nodes = jnp.nonzero(g.deg > 0)[0].astype(jnp.int32)
    reps = []
    for i in range(num_walks):
        if shuffle_key is not None:
            nodes_i = jax.random.permutation(
                jax.random.fold_in(shuffle_key, i), nodes
            )
        else:
            nodes_i = nodes
        reps.append(nodes_i)
    return jnp.concatenate(reps)


def simulate_walks(
    g: Graph,
    num_walks: int,
    walk_length: int,
    key: jax.Array,
    p: float = 1.0,
    q: float = 1.0,
    weighted: bool = False,
    second_order_mode: str = "rejection",
    max_trials: int | None = None,
    sort_gather: bool = False,
) -> jax.Array:
    """The reference ``simulate_walks`` (node2vec.py:41-59): ``num_walks``
    shuffled passes over all nodes, ``walk_length`` *nodes* per walk
    (walk_length-1 transitions).  Returns int32[num_walks*V', walk_length].
    """
    from graphtpu.walks.node2vec import node2vec_walks

    k_shuffle, k_walk = jax.random.split(key)
    starts = walk_starts(g, num_walks, k_shuffle)
    if p == 1.0 and q == 1.0:
        return uniform_walks(
            g, starts, walk_length - 1, k_walk, weighted=weighted,
            sort_gather=sort_gather,
        )
    return node2vec_walks(
        g,
        starts,
        walk_length - 1,
        p=p,
        q=q,
        key=k_walk,
        weighted=weighted,
        mode=second_order_mode,
        max_trials=max_trials,
    )


def walks_to_corpus(walks) -> list:
    """Host-side: walk tensor -> list of node-id lists (drop -1 padding),
    matching the walk lists fed to gensim (main.py:92-97)."""
    out = []
    for row in np.asarray(walks):
        stop = np.argmax(row < 0) if (row < 0).any() else len(row)
        out.append([int(x) for x in row[:stop]])
    return out
