"""Graph relabeling for gather locality (the round-5 DMA-coalescing
prerequisite).

The streaming SpMV's floor is the per-row DMA rate: each stream item
gathers table row ``col[t]``, and consecutive items hit unrelated rows
under arbitrary vertex labels.  A locality-improving relabeling makes
consecutive CSR slots reference ADJACENT rows far more often, which is
what lets a future kernel merge k adjacent-slot items into one k-row
DMA.  The same locality helps the walk engines' per-hop gathers (the
``col`` array of a V=10M graph is 320 MB of random access).

Two standard orders, both host-side one-shot passes:

* :func:`bfs_order` — Cuthill-McKee-flavoured BFS (neighbours enqueued
  in degree order), the classic bandwidth-reducing relabeling;
* :func:`degree_order` — hubs first; groups the high-traffic rows.

``relabel_graph`` applies a permutation at the CSR slot level (rows
gathered, neighbour ids mapped, rows re-sorted), preserving weights and
multiplicity exactly; ``locality_score`` measures the adjacent-slot
fraction the coalescer would exploit.

Reference context: the reference's Giraph runs inherit whatever ids the
generator produced (``utils/GraphGeneratorBf.java``); locality is a
device-side concern with no reference analog.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from graphtpu.core.graph import Graph, host_csr


def bfs_order(g: Graph, start: Optional[int] = None) -> np.ndarray:
    """int32[V] permutation: ``order[new_id] = old_id`` from a BFS that
    visits neighbours in increasing-degree order (Cuthill-McKee),
    restarting at the lowest-degree unvisited node per component."""
    rp, col, _, deg = host_csr(g)
    rp, col, deg = np.asarray(rp), np.asarray(col), np.asarray(deg)
    v = g.n_nodes
    order = np.empty(v, np.int64)
    seen = np.zeros(v, bool)
    pos = 0
    # component seeds: lowest degree first (isolated nodes trail)
    seeds = np.argsort(deg, kind="stable")
    if start is not None:
        seeds = np.concatenate([[start], seeds])
    si = 0
    head = 0
    for s in seeds:
        if seen[s]:
            continue
        seen[s] = True
        order[pos] = s
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = np.unique(col[rp[u] : rp[u + 1]])
            nbrs = nbrs[~seen[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                seen[nbrs] = True
                order[pos : pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    assert pos == v, (pos, v)
    return order.astype(np.int32)


def degree_order(g: Graph) -> np.ndarray:
    """int32[V] permutation: hubs first (stable)."""
    deg = np.asarray(g.deg)
    return np.argsort(-deg, kind="stable").astype(np.int32)


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee via scipy's C implementation — the
    bandwidth-reducing order at flagship scale (10M nodes) where the
    Python BFS loop of :func:`bfs_order` is too slow.  Falls back to
    :func:`bfs_order` without scipy."""
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except Exception:  # pragma: no cover - scipy always in this image
        return bfs_order(g)
    rp, col, _, _ = host_csr(g)
    rp = np.asarray(rp)
    col = np.asarray(col)
    v = g.n_nodes
    m = csr_matrix(
        (np.ones(len(col), np.int8), col, rp), shape=(v, v)
    )
    return np.asarray(
        reverse_cuthill_mckee(m, symmetric_mode=True), np.int32
    )


def relabel_graph(g: Graph, order: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Apply ``order[new_id] = old_id``; returns ``(g2, inv)`` with
    ``inv[old_id] = new_id`` (use it to map queries/results back).

    Slot-exact: multiplicities and weights are preserved; rows are
    re-sorted by (new) neighbour id like every Graph row.
    """
    import jax.numpy as jnp

    rp, col, w, deg = host_csr(g)
    rp, col, deg = np.asarray(rp), np.asarray(col), np.asarray(deg)
    w = None if w is None else np.asarray(w)
    v = g.n_nodes
    order = np.asarray(order, np.int64)
    inv = np.empty(v, np.int64)
    inv[order] = np.arange(v)

    new_deg = deg[order]
    new_rp = np.zeros(v + 1, np.int64)
    np.cumsum(new_deg, out=new_rp[1:])
    # vectorized slot permutation (a per-row Python loop dies at the 10M
    # flagship scale): stable-sort every edge by (new row, new neighbour)
    row_of_e = np.repeat(np.arange(v), np.diff(rp))
    new_row = inv[row_of_e]
    new_nb = inv[col.astype(np.int64)]
    perm = np.lexsort((new_nb, new_row))
    new_col = new_nb[perm]
    new_w = w[perm] if w is not None else None
    g2 = Graph(
        row_ptr=jnp.asarray(new_rp.astype(np.int32)),
        col=jnp.asarray(new_col.astype(np.int32)),
        weight=None if new_w is None else jnp.asarray(new_w),
        deg=jnp.asarray(new_deg.astype(np.int32)),
        max_degree=g.max_degree,
    )
    return g2, inv.astype(np.int32)


def locality_score(g: Graph, window: int = 1) -> float:
    """Fraction of consecutive CSR slots whose neighbour ids are within
    ``window`` of each other — the share of stream items a k-row
    DMA-coalescing kernel could merge."""
    col = np.asarray(g.col)
    if len(col) < 2:
        return 0.0
    d = np.abs(np.diff(col.astype(np.int64)))
    return float((d <= window).mean())
