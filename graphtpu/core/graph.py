"""CSR graph containers, device-first.

The reference keeps graphs as per-node Java adjacency lists
(``DeepSim/TopSimAll/src/structures/Graph.java:16``, ``DGraph.java:17``,
``WGraph.java:22``, ``DWGraph.java:21``) or networkx objects
(``node2vec/src/main.py:76-89``).  On the device the natural layout is a flat CSR in
device memory: ``row_ptr[V+1]`` / ``col[E]`` / optional ``weight[E]``, with neighbours
*sorted* within each row.  Sorting matters twice:

  * the reference walker iterates ``sorted(G.neighbors(cur))``
    (``node2vec/src/node2vec.py:25``), so sorted CSR reproduces its
    neighbour-index convention exactly, and
  * sorted rows give O(log d) edge-existence checks (vectorised binary
    search) which the second-order node2vec bias needs in-kernel.

All arrays are device arrays; a Graph is a pytree so it can be closed over or
passed through ``jax.jit`` freely.  Construction happens host-side in numpy.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row_ptr", "col", "weight", "deg"],
    meta_fields=["max_degree"],
)
@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected (or single-direction) graph in CSR form.

    ``row_ptr``: int32[V+1]; ``col``: int32[E] sorted within each row;
    ``weight``: float32[E] or None; ``deg``: int32[V].
    ``max_degree`` is static Python metadata so kernels can size padded
    buffers at trace time.
    """

    row_ptr: jax.Array
    col: jax.Array
    weight: Optional[jax.Array]
    deg: jax.Array
    max_degree: int

    @property
    def n_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        """Directed edge slots in CSR (an undirected edge occupies two)."""
        return self.col.shape[0]

    @property
    def is_weighted(self) -> bool:
        return self.weight is not None

    # -- host-side conveniences (not for use inside jit) --
    def neighbors(self, v: int) -> np.ndarray:
        lo, hi = int(self.row_ptr[v]), int(self.row_ptr[v + 1])
        return np.asarray(self.col[lo:hi])

    def degree(self, v: int) -> int:
        return int(self.deg[v])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["out", "in_"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class DiGraph:
    """Directed graph: separate out-CSR and in-CSR.

    Mirrors the reference's ``DGraph`` (separate ``outs``/``ins`` lists,
    ``structures/DGraph.java:17-131``) and ``DWGraph`` for the weighted case.
    """

    out: Graph
    in_: Graph

    @property
    def n_nodes(self) -> int:
        return self.out.n_nodes

    @property
    def n_edges(self) -> int:
        return self.out.n_edges


def _build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    wts: Optional[np.ndarray],
    n_nodes: int,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Sort edges by (src, dst) and emit CSR arrays (numpy, host)."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if wts is not None:
        wts = wts[order]
    deg = np.bincount(src, minlength=n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    if row_ptr[-1] <= np.iinfo(np.int32).max:
        row_ptr = row_ptr.astype(np.int32)
    return row_ptr, dst.astype(np.int32), wts, deg


def build_graph(
    edges: np.ndarray,
    weights: Optional[np.ndarray] = None,
    n_nodes: Optional[int] = None,
    directed: bool = False,
    dedup: bool = True,
):
    """Build a :class:`Graph` (undirected) or :class:`DiGraph` (directed).

    ``edges``: int array [E, 2].  Undirected edges are mirrored into both
    rows, like ``Graph.addEdge`` inserting both directions
    (``structures/Graph.java:53-57``).  ``dedup=True`` collapses duplicate
    (src, dst) pairs (networkx semantics in ``node2vec/src/main.py:76-89``);
    ``dedup=False`` keeps multi-edges (Java semantics).
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    src = edges[:, 0].astype(np.int64)
    dst = edges[:, 1].astype(np.int64)
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)

    def dedup_pairs(s, d, w):
        key = s * n_nodes + d
        uniq, idx = np.unique(key, return_index=True)
        s2, d2 = uniq // n_nodes, uniq % n_nodes
        w2 = None
        if w is not None:
            # keep the *last* weight for duplicates (networkx overwrite).
            lastw = np.empty(len(uniq), dtype=np.float32)
            inv = np.searchsorted(uniq, key)
            lastw[inv] = w
            w2 = lastw
        return s2, d2, w2

    if directed:
        if dedup:
            src, dst, weights = dedup_pairs(src, dst, weights)
        ws = weights
        out = _finish_graph(*_build_csr(src, dst, ws, n_nodes))
        in_ = _finish_graph(*_build_csr(dst, src, ws, n_nodes))
        return DiGraph(out=out, in_=in_)

    # undirected: mirror, then (optionally) dedup directed slots
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = None if weights is None else np.concatenate([weights, weights])
    if dedup:
        s2, d2, w2 = dedup_pairs(s2, d2, w2)
    return _finish_graph(*_build_csr(s2, d2, w2, n_nodes))


def _finish_graph(row_ptr, col, wts, deg) -> Graph:
    g = Graph(
        row_ptr=jnp.asarray(row_ptr),
        col=jnp.asarray(col),
        weight=None if wts is None else jnp.asarray(wts),
        deg=jnp.asarray(deg),
        max_degree=int(deg.max(initial=0)),
    )
    # host-side CSR mirror for plan builders (reduction trees, shards,
    # alias tables): host consumers read it instead of paying a
    # device->host round trip for arrays the host built.  Private (not a
    # pytree field): dropped by jit tracing, used via host_csr(g).
    object.__setattr__(g, "_host_csr", (row_ptr, col, wts, deg))
    return g


def host_csr(g: Graph):
    """(row_ptr, col, weight, deg) as numpy — from the construction-time
    mirror when available, else one device readback."""
    cached = getattr(g, "_host_csr", None)
    if cached is not None:
        return cached
    return (
        np.asarray(g.row_ptr),
        np.asarray(g.col),
        None if g.weight is None else np.asarray(g.weight),
        np.asarray(g.deg),
    )


def read_edgelist_graph(
    path: str,
    delimiter: Optional[str] = None,
    weighted: bool = False,
    directed: bool = False,
    n_nodes: Optional[int] = None,
    dedup: bool = True,
):
    """Read an edge-list text file into a Graph/DiGraph.

    Accepts the reference's formats: whitespace- or comma-separated
    ``src dst [weight]`` lines (``node2vec/src/main.py:76-89`` uses
    networkx ``read_edgelist``; the Java loaders split on
    ``MyConfiguration.SEPARATOR`` = ","). Unweighted graphs get weight 1
    implicitly (weights dropped when ``weighted=False``).
    """
    from graphtpu.io.edgelist import read_edgelist

    edges, wts = read_edgelist(path, delimiter=delimiter)
    if not weighted:
        wts = None
    return build_graph(edges, wts, n_nodes=n_nodes, directed=directed, dedup=dedup)


def load_graph_cached(
    path: str,
    n_nodes: Optional[int] = None,
    weighted: bool = False,
    delimiter: Optional[str] = None,
) -> Graph:
    """read_edgelist_graph with a CSR ``.csr.npz`` sidecar cache.

    First touch parses (native C++ tokenizer) and lexsorts the edge list
    — minutes at the reference's 10M-vertex scale — then persists the
    finished CSR; later touches memory-map-load in seconds.  The cache is
    invalidated when the edge file is newer."""
    npz = path + ".csr.npz"
    if os.path.exists(npz) and os.path.getmtime(npz) >= os.path.getmtime(path):
        z = np.load(npz)
        w = z["weight"] if "weight" in z.files else None
        return _finish_graph(z["row_ptr"], z["col"], w, z["deg"])
    g = read_edgelist_graph(
        path, delimiter=delimiter, weighted=weighted, n_nodes=n_nodes
    )
    rp, col, w, deg = host_csr(g)
    arrs = dict(row_ptr=np.asarray(rp), col=np.asarray(col), deg=np.asarray(deg))
    if w is not None:
        arrs["weight"] = np.asarray(w)
    tmp = npz + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, npz)
    return g


def pad_graph_nodes(g: Graph, n_nodes: int) -> Graph:
    """Extend ``g`` with isolated (degree-0) pad nodes up to ``n_nodes``.

    Pad nodes have empty CSR rows and are never referenced as targets, so
    algorithms see identical results on the real prefix; used to make V
    divisible by a mesh axis.
    """
    v = g.n_nodes
    assert n_nodes >= v
    if n_nodes == v:
        return g
    rp, col, wts, deg = host_csr(g)
    rp = np.asarray(rp)
    rp2 = np.concatenate([rp, np.full(n_nodes - v, rp[-1], rp.dtype)])
    deg2 = np.concatenate([np.asarray(deg), np.zeros(n_nodes - v, np.int32)])
    return _finish_graph(rp2, np.asarray(col), wts, deg2)


# ---------------------------------------------------------------------------
# Padded adjacency (for dense-bias kernels) and normalized operators
# ---------------------------------------------------------------------------


def padded_neighbors(
    g: Graph, pad_to: Optional[int] = None, fill: int = -1
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Export [V, Dmax] padded neighbour (and weight) matrices.

    Rows keep CSR (sorted) order; unused slots get ``fill``.  Used by the
    exact second-order bias kernel and by small-graph utilities. O(V*Dmax)
    memory — callers on power-law graphs should prefer CSR kernels.
    """
    dmax = int(pad_to if pad_to is not None else max(g.max_degree, 1))
    v = g.n_nodes
    row_ptr = np.asarray(g.row_ptr)
    col = np.asarray(g.col)
    nbrs = np.full((v, dmax), fill, dtype=np.int32)
    wts = None
    if g.weight is not None:
        wts = np.zeros((v, dmax), dtype=np.float32)
        wsrc = np.asarray(g.weight)
    deg = np.asarray(g.deg)
    for u in range(v):  # host-side; fine up to ~1e6 nodes
        lo, d = row_ptr[u], deg[u]
        nbrs[u, :d] = col[lo : lo + d]
        if wts is not None:
            wts[u, :d] = wsrc[lo : lo + d]
    return jnp.asarray(nbrs), (None if wts is None else jnp.asarray(wts))


def dense_adjacency(g: Graph, dtype=jnp.float32) -> jax.Array:
    """Dense [V, V] (weighted) adjacency; for small-graph exact algorithms."""
    v = g.n_nodes
    a = np.zeros((v, v), dtype=np.float32)
    row_ptr = np.asarray(g.row_ptr)
    col = np.asarray(g.col)
    w = np.ones(g.n_edges, np.float32) if g.weight is None else np.asarray(g.weight)
    src = np.repeat(np.arange(v), np.asarray(g.deg))
    np.add.at(a, (src, col[: len(src)]), w[: len(src)])
    return jnp.asarray(a, dtype=dtype)


def column_normalized(a: jax.Array) -> jax.Array:
    """W = A D^-1 (columns sum to 1 where in-degree > 0)."""
    colsum = a.sum(axis=0, keepdims=True)
    return jnp.where(colsum > 0, a / jnp.where(colsum > 0, colsum, 1.0), 0.0)


def row_normalized(a: jax.Array) -> jax.Array:
    """P with P[i, u] = a[i, u] / sum_u a[i, u] (row-stochastic).

    Operator form of the exact SimRank update ``sim'(i,j) = C/(d_i d_j) *
    sum_{u in N(i), v in N(j)} sim(u,v)`` (``simrank/SimRank.java:67-77``)
    and its weighted form (``weighted/WeightedSimRank.java:68-93``):
    S' = C * P S P^T.  Rows define each node's *own* neighbour weights, so
    asymmetric weighted graphs follow the reference semantics exactly.
    """
    rowsum = a.sum(axis=1, keepdims=True)
    return jnp.where(rowsum > 0, a / jnp.where(rowsum > 0, rowsum, 1.0), 0.0)
