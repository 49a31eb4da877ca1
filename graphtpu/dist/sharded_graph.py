"""Partitioned CSR — the graph no longer fits one worker.

The reference's defining distributed property is a graph larger than any
single machine: Giraph hash-partitions vertices over workers and every
vertex's adjacency list lives only on its owner
(``giraph/CombineBatchSingleWalkVertexReuse.java:39-48`` runs 10M vertices
over 14 workers; ``BatchSingleWalkVertex_Byte.java:38-41`` 1M over 12).
The device mapping partitions by *contiguous node range* so ownership is a
division, not a hash lookup: device ``d`` owns nodes
``[d*nodes_per, (d+1)*nodes_per)`` and holds only their CSR rows.

Layout: every per-shard array is stacked on a leading mesh axis and
device_put with ``PartitionSpec(axis, ...)`` so each device physically
holds one ``[1, ...]`` block:

  * ``row_ptr  [n_dev, nodes_per+1]`` — rebased per shard (``[d, 0] == 0``)
  * ``col      [n_dev, e_cap]``       — global target ids, -1 padded
  * ``weight   [n_dev, e_cap]``       — optional
  * ``deg      [n_dev, nodes_per]``

``e_cap`` is the max shard edge count (rounded up to 128 lanes), so
per-device CSR memory is O(E/n_dev + slack) instead of O(E).  Degrees of
*remote* nodes are still needed by the SimRank increment formula
(``deg(path[i]) / deg(path[2i])``, ``SingleRandomWalk.java:53-106``), so a
replicated ``deg_global [v_padded]`` rides along — O(V) ints, 40 MB at
V=10M, the same trade Giraph makes by shipping degrees inside walker
messages.

Inside ``shard_map`` the squeezed block reconstructs a plain local
:class:`~graphtpu.core.graph.Graph`, so every single-chip CSR kernel
(``uniform_neighbor``, ``weighted_neighbor``, frontier expansion) runs
unchanged against the shard with node ids rebased by ``- d*nodes_per``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.graph import Graph, host_csr


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row_ptr", "col", "weight", "deg", "deg_global"],
    meta_fields=["n_nodes", "nodes_per", "max_degree"],
)
@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """CSR partitioned by contiguous node range over a 1-D mesh axis."""

    row_ptr: jax.Array            # [n_dev, nodes_per + 1], rebased
    col: jax.Array                # [n_dev, e_cap], global ids, -1 pad
    weight: Optional[jax.Array]   # [n_dev, e_cap] or None
    deg: jax.Array                # [n_dev, nodes_per]
    deg_global: jax.Array         # [n_dev * nodes_per], replicated
    n_nodes: int                  # true (unpadded) node count
    nodes_per: int                # nodes owned per device
    max_degree: int

    @property
    def n_dev(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def e_cap(self) -> int:
        return self.col.shape[1]


def shard_graph(
    g: Graph, n_dev: int, mesh: Optional[Mesh] = None
) -> ShardedGraph:
    """Partition ``g`` into ``n_dev`` contiguous-range CSR shards.

    When ``mesh`` is given, the stacked arrays are device_put so each
    device holds exactly its own block (and the replicated ``deg_global``).
    """
    v = g.n_nodes
    nodes_per = -(-v // n_dev)
    v_p = nodes_per * n_dev
    rp_h, col_h, w_h, deg_h = host_csr(g)
    row_ptr = np.asarray(rp_h).astype(np.int64)
    col = np.asarray(col_h)
    wts = None if w_h is None else np.asarray(w_h)
    deg = np.asarray(deg_h)

    counts = [
        int(row_ptr[min((d + 1) * nodes_per, v)] - row_ptr[min(d * nodes_per, v)])
        for d in range(n_dev)
    ]
    e_cap = max(128, -(-max(counts) // 128) * 128)

    rp_s = np.zeros((n_dev, nodes_per + 1), np.int32)
    col_s = np.full((n_dev, e_cap), -1, np.int32)
    w_s = None if wts is None else np.zeros((n_dev, e_cap), np.float32)
    deg_s = np.zeros((n_dev, nodes_per), np.int32)
    for d in range(n_dev):
        lo, hi = d * nodes_per, min((d + 1) * nodes_per, v)
        if lo >= v:
            continue
        e_lo, e_hi = int(row_ptr[lo]), int(row_ptr[hi])
        local = row_ptr[lo : hi + 1] - row_ptr[lo]
        rp_s[d, : hi - lo + 1] = local
        rp_s[d, hi - lo + 1 :] = local[-1]
        col_s[d, : e_hi - e_lo] = col[e_lo:e_hi]
        if w_s is not None:
            w_s[d, : e_hi - e_lo] = wts[e_lo:e_hi]
        deg_s[d, : hi - lo] = deg[lo:hi]
    deg_g = np.zeros(v_p, np.int32)
    deg_g[:v] = deg

    def put(x, spec):
        if mesh is None:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(mesh, spec))

    axis = mesh.axis_names[0] if mesh is not None else None
    return ShardedGraph(
        row_ptr=put(rp_s, P(axis, None)),
        col=put(col_s, P(axis, None)),
        weight=None if w_s is None else put(w_s, P(axis, None)),
        deg=put(deg_s, P(axis, None)),
        deg_global=put(deg_g, P()),
        n_nodes=v,
        nodes_per=nodes_per,
        max_degree=g.max_degree,
    )


def local_graph(
    row_ptr_blk: jax.Array,
    col_blk: jax.Array,
    deg_blk: jax.Array,
    max_degree: int,
    weight_blk: Optional[jax.Array] = None,
) -> Graph:
    """Rebuild the device-local :class:`Graph` from shard_map blocks.

    Blocks arrive as ``[1, ...]`` (one mesh row per device); node ids must
    be rebased by the caller (``local = global - me * nodes_per``).
    """
    return Graph(
        row_ptr=row_ptr_blk[0],
        col=col_blk[0],
        weight=None if weight_blk is None else weight_blk[0],
        deg=deg_blk[0],
        max_degree=max_degree,
    )
