"""Sharded DENSE exact SimRank — S row-sharded, W replicated.

S' = C * W S W^T with S sharded PartitionSpec('data', None) and W
replicated: XLA splits the matmuls per shard and inserts the
collectives for the contractions (reduce-scatter / all-gather as
needed).  NOTE the memory profile: the dense [V, V] W is replicated on
every device, so this form is a GSPMD collectives demo for small-V,
compute-bound graphs only.  The
production scale-out of the reference's gold-standard computation (the
14-worker Giraph cluster's role) is
:func:`graphtpu.dist.spmm_sharded.sharded_simrank_spmm`, which shards
both S (O(V²/n_dev)) and P (O(E/n_dev)) and communicates only ring
block rotations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.config import SimRankConfig
from graphtpu.core.graph import (
    Graph,
    dense_adjacency,
    pad_graph_nodes,
    row_normalized,
)


def sharded_exact_simrank(
    g: Graph,
    mesh: Mesh,
    cfg: SimRankConfig = SimRankConfig(),
    dtype=jnp.float32,
    matmul_precision: str = "highest",
) -> jax.Array:
    """Dense [V, V] SimRank with S row-sharded over mesh axis 'data'.

    V is padded with isolated nodes to a multiple of the axis size (their
    zero rows and columns of W leave the real block unchanged)."""
    n_data = mesh.shape["data"]
    v_real = g.n_nodes
    v = -(-v_real // n_data) * n_data
    g = pad_graph_nodes(g, v)
    row_shard = NamedSharding(mesh, P("data", None))
    repl = NamedSharding(mesh, P())

    a = dense_adjacency(g, dtype=jnp.float32)
    w = jax.device_put(row_normalized(a).astype(dtype), repl)
    eye = jnp.eye(v, dtype=dtype)

    # eye is an argument: a closure would embed it as a [V, V] constant
    @partial(jax.jit, out_shardings=row_shard)
    def run(w, eye):
        eye_s = jax.lax.with_sharding_constraint(eye, row_shard)
        def body(_, s):
            s = cfg.c * (w @ (s @ w.T))
            s = s * (1 - eye_s) + eye_s
            return jax.lax.with_sharding_constraint(s, row_shard)
        with jax.default_matmul_precision(matmul_precision):
            s = jax.lax.fori_loop(0, cfg.iterations, body, eye_s)
        return s * (1 - eye_s)

    return run(w, eye)[:v_real, :v_real]
