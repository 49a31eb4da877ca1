"""Graph traversal utilities — BFS hop distances.

``utils/BFSDist.java:18-40`` computes BFS hop distances from the first
``maxStat`` sources into a byte matrix.  Device form: level-synchronous
frontier propagation straight over the CSR — the next frontier is a
per-node OR of the current frontier over each node's neighbour segment,
computed as a column gather + prefix-sum + row-boundary difference (no
dense [V, V] adjacency and no scatters), so memory is O(S * E) per source
chunk instead of O(V^2).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph

_UNREACHED = np.iinfo(np.int32).max


@partial(jax.jit, static_argnames=("max_dist",))
def _bfs_chunk(row_ptr, col, src, max_dist: int):
    s = src.shape[0]
    v = row_ptr.shape[0] - 1
    dist = jnp.full((s, v), _UNREACHED, jnp.int32)
    frontier = jnp.zeros((s, v), bool).at[jnp.arange(s), src].set(True)
    dist = jnp.where(frontier, 0, dist)

    def expand(front):
        # reach[s, i] = OR of front[s, n] over neighbours n of i: gather the
        # frontier onto edge slots (contiguous per CSR row), prefix-sum, and
        # difference at row boundaries — a segment-OR with zero scatters.
        gathered = front[:, col].astype(jnp.float32)            # [S, E]
        csum = jnp.cumsum(gathered, axis=1)
        padded = jnp.concatenate(
            [jnp.zeros((s, 1), jnp.float32), csum], axis=1
        )                                                        # [S, E+1]
        return (padded[:, row_ptr[1:]] - padded[:, row_ptr[:-1]]) > 0

    def body(carry):
        d, front, dist = carry
        nxt = expand(front) & (dist == _UNREACHED)
        dist = jnp.where(nxt, d + 1, dist)
        return d + 1, nxt, dist

    def cond(carry):
        d, front, _ = carry
        return (d < max_dist) & front.any()

    _, _, dist = jax.lax.while_loop(cond, body, (jnp.int32(0), frontier, dist))
    return dist


def bfs_distances(
    g: Graph,
    sources: Optional[np.ndarray] = None,
    max_dist: int = 127,
    unreachable: int = -1,
    source_chunk: int = 32,
) -> np.ndarray:
    """int32 [S, V] hop distances (unreachable -> ``unreachable``).

    Sources are processed in chunks of ``source_chunk``; each chunk's
    working set is [chunk, E] floats, so arbitrary-V graphs work as long
    as a chunk of edge-gathered frontiers fits.
    """
    if sources is None:
        sources = np.arange(min(g.n_nodes, 100), dtype=np.int32)
    sources = np.asarray(sources, np.int32)
    n = len(sources)
    chunk = min(source_chunk, max(n, 1))
    out = np.empty((n, g.n_nodes), np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        src = sources[lo:hi]
        if len(src) < chunk:  # pad to keep one compiled shape
            src = np.concatenate([src, np.zeros(chunk - len(src), np.int32)])
        dist = _bfs_chunk(g.row_ptr, g.col, jnp.asarray(src), max_dist)
        out[lo:hi] = np.asarray(dist)[: hi - lo]
    out[out == _UNREACHED] = unreachable
    return out
