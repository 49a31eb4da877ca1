"""Sharded sparse SimRank — S' = C·P·S·Pᵀ with S and P partitioned.

The reference's gold-standard computation ran exact SimRank on a
14-worker cluster (``simrank/SimRank.java:67-77`` semantics at
distributed scale); round 2's ``sharded_exact_simrank`` densified A and
replicated the [V, V] dense W per device — O(V²) everywhere, unusable
past ~30k nodes.  This module is the real thing:

* **S is column-sharded**: device d holds ``S[:, c_d]`` — O(V²/n_dev).
* **P is row-sharded**: device d holds a gather-reduction-tree plan for
  only its row range's CSR — O(E/n_dev) slots (the same exact-f32 tree
  as :mod:`graphtpu.kernels.spmm`, built per shard and depth/width
  padded so every device runs the same program).
* **One product P·X = one ring rotation**: at each of n_dev steps,
  device d multiplies its P rows against the column block currently in
  hand — producing tile (P·X)[r_d, c] — then passes the block to its
  ring neighbour with ``ppermute``.  After n_dev steps device d holds
  the full row block (P·X)[r_d, :].
* **The transpose is free**: the row block's local transpose is exactly
  the column block the *next* product needs — and S' itself is
  symmetric, so the iteration's output row block transposes into the
  next iteration's input column block.  Two ring rotations per
  iteration, zero other collectives.

Per-device: memory O(V²/n_dev + E/n_dev), compute O(E·V/n_dev),
communication O(V²/n_dev) per product — the textbook 1-D SUMMA
decomposition; the ``ppermute`` rides the device interconnect.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.config import SimRankConfig
from graphtpu.core.graph import Graph, host_csr, pad_graph_nodes
from graphtpu.kernels.spmm import build_reduction_tree


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "weights"],
    meta_fields=["n_nodes", "rows_per", "n_dev"],
)
@dataclasses.dataclass(frozen=True)
class ShardedTreePlan:
    """Per-device gather-tree plans, stacked on a leading mesh axis.

    ``levels[k]``: int32[n_dev, M_k, W]; level 0 slots index the GLOBAL
    row space of X (the full column block each device holds), deeper
    levels index the previous level's local output rows.  All shards are
    padded to a common depth (identity levels) and common per-level row
    counts (zero-weight rows), so one program serves every device.
    """

    levels: Tuple[jax.Array, ...]
    weights: Tuple[jax.Array, ...]
    n_nodes: int      # padded global V (divisible by n_dev)
    rows_per: int     # output rows per device
    n_dev: int


def _subgraph(g: Graph, lo: int, hi: int) -> Graph:
    """Host-side row-range sub-CSR (rows [lo, hi), global column ids)."""
    rp, col, w, deg = host_csr(g)
    rp = np.asarray(rp).astype(np.int64)
    e_lo, e_hi = int(rp[lo]), int(rp[hi])
    return Graph(
        row_ptr=jnp.asarray((rp[lo : hi + 1] - rp[lo]).astype(np.int32)),
        col=jnp.asarray(np.asarray(col)[e_lo:e_hi]),
        weight=None if w is None else jnp.asarray(np.asarray(w)[e_lo:e_hi]),
        deg=jnp.asarray(np.asarray(deg)[lo:hi]),
        max_degree=g.max_degree,
    )


def build_sharded_tree_plan(
    g: Graph,
    n_dev: int,
    width: int = 8,
    weighted: bool = False,
    mesh: Optional[Mesh] = None,
) -> ShardedTreePlan:
    """Split P into n_dev row-range tree plans, equalised and stacked.

    When ``mesh`` is given the stacked arrays are device_put so each
    device physically holds only its own plan block (O(E/n_dev))."""
    v = g.n_nodes
    assert v % n_dev == 0, "pad the graph to a multiple of n_dev first"
    rows_per = v // n_dev
    trees = [
        build_reduction_tree(
            _subgraph(g, d * rows_per, (d + 1) * rows_per),
            width=width,
            weighted=weighted,
            block=8,
        )
        for d in range(n_dev)
    ]
    depth = max(len(t.levels) for t in trees)

    # equalise depth: append identity levels (slot=own row, weight 1)
    def extend(t):
        levels = [np.asarray(l) for l in t.levels]
        weights = [np.asarray(w) for w in t.weights]
        real = list(t.real_rows)
        while len(levels) < depth:
            r = real[-1]
            sl = np.zeros((r, width), np.int32)
            sl[:, 0] = np.arange(r)
            wt = np.zeros((r, width), np.float32)
            wt[:, 0] = 1.0
            levels.append(sl)
            weights.append(wt)
            real.append(r)
        return levels, weights, real

    ext = [extend(t) for t in trees]
    out_levels, out_weights = [], []
    for k in range(depth):
        mk = max(e[0][k].shape[0] for e in ext)
        ls = np.zeros((n_dev, mk, width), np.int32)
        ws = np.zeros((n_dev, mk, width), np.float32)
        for d, (lv, wt, _) in enumerate(ext):
            ls[d, : lv[k].shape[0]] = lv[k]
            ws[d, : wt[k].shape[0]] = wt[k]
        out_levels.append(ls)
        out_weights.append(ws)

    def put(x):
        if mesh is None:
            return jnp.asarray(x)
        axis = mesh.axis_names[0]
        return jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P(axis, None, None))
        )

    return ShardedTreePlan(
        levels=tuple(put(l) for l in out_levels),
        weights=tuple(put(w) for w in out_weights),
        n_nodes=v,
        rows_per=rows_per,
        n_dev=n_dev,
    )


def _tree_apply(levels, weights, x: jax.Array, rows_per: int) -> jax.Array:
    """Run the stacked plan's LOCAL block against table x: [V or M, C] ->
    [rows_per, C] float32.  levels/weights arrive as [1, M_k, W] blocks.
    Gathered rows are promoted to f32 BEFORE the weighted sums, so a
    bf16-iterate run (halved ring payloads + memory) still accumulates
    in f32 and rounds once per product."""
    table = x
    for lv, wt in zip(levels, weights):
        lv, wt = lv[0], wt[0]
        acc = None
        for j in range(lv.shape[1]):
            r = table[lv[:, j]].astype(jnp.float32) * wt[:, j][:, None]
            acc = r if acc is None else acc + r
        table = acc
    return table[:rows_per]


def make_sharded_iter(
    g: Graph,
    mesh: Mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[ShardedTreePlan] = None,
    dtype=jnp.float32,
):
    """Build the sharded-iteration executables: returns
    ``(plan, v, init, run_n, zero_diag)`` where ``run_n(s, n_iters, *lw)``
    advances ``n_iters`` iterations INSIDE one jit (a ``fori_loop`` —
    no host dispatch or device round-trip per iteration) and is
    independently lowerable for compiled memory analysis."""
    from jax import shard_map

    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    v_real = g.n_nodes
    v = -(-v_real // n_dev) * n_dev
    gp = pad_graph_nodes(g, v) if v != v_real else g
    if plan is None:
        plan = build_sharded_tree_plan(
            gp, n_dev, width=width, weighted=weighted, mesh=mesh
        )
    rows_per = plan.rows_per

    plan_specs = tuple(P(axis, None, None) for _ in plan.levels)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis),) + plan_specs + plan_specs,
        out_specs=P(None, axis),
    )
    def one_iter(s_blk, *lw):
        levels, weights = lw[: len(plan.levels)], lw[len(plan.levels) :]
        me = jax.lax.axis_index(axis)

        def ring_product(x_blk):
            """P · X from X's column blocks: returns my row block
            (P·X)[r_me, :] via n_dev rotate-and-multiply steps."""
            y = jax.lax.pcast(
                jnp.zeros((rows_per, v), x_blk.dtype), axis, to="varying"
            )

            def step(k, carry):
                y, blk = carry
                # block currently in hand started at device (me + k) % n
                c = (me + k) % n_dev
                tile = _tree_apply(levels, weights, blk, rows_per)
                y = jax.lax.dynamic_update_slice(
                    y, tile.astype(y.dtype), (0, c * rows_per)
                )
                blk = jax.lax.ppermute(
                    blk, axis,
                    [(i, (i - 1) % n_dev) for i in range(n_dev)],
                )
                return y, blk

            y, _ = jax.lax.fori_loop(0, n_dev, step, (y, x_blk))
            return y

        ps_rows = ring_product(s_blk)          # (P·S)[r_me, :]
        z_blk = ps_rows.T                      # (P·S)ᵀ[:, c_me] — local
        out_rows = cfg.c * ring_product(z_blk)  # C·(P·(P·S)ᵀ)[r_me, :]
        # pin diag: row i of my block is global row me*rows_per + i
        rows_g = me * rows_per + jnp.arange(rows_per, dtype=jnp.int32)
        cols_g = jax.lax.broadcasted_iota(jnp.int32, (rows_per, v), 1)
        out_rows = jnp.where(cols_g == rows_g[:, None], 1.0, out_rows)
        # S' is symmetric: my output ROW block transposed IS my next
        # input COLUMN block
        return out_rows.T

    @partial(
        shard_map, mesh=mesh, in_specs=(P(None, axis),),
        out_specs=P(None, axis),
    )
    def zero_diag(s_blk):
        me = jax.lax.axis_index(axis)
        cols_g = me * rows_per + jnp.arange(rows_per, dtype=jnp.int32)
        rows_g = jax.lax.broadcasted_iota(jnp.int32, (v, rows_per), 0)
        return jnp.where(rows_g == cols_g[None, :], 0.0, s_blk)

    # identity start, built block-local (a traced dummy threads through so
    # XLA doesn't constant-fold the [V, V] iota client-side — see CLAUDE.md)
    @partial(shard_map, mesh=mesh, in_specs=(P(axis),), out_specs=P(None, axis))
    def init(dummy):
        me = jax.lax.axis_index(axis)
        cols_g = me * rows_per + jnp.arange(rows_per, dtype=jnp.int32)
        rows_g = jax.lax.broadcasted_iota(jnp.int32, (v, rows_per), 0)
        return (rows_g == cols_g[None, :]).astype(dtype) + dummy.astype(dtype)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
    def run_n(s, n_iters, *lw):
        return jax.lax.fori_loop(
            0, n_iters, lambda _, x: one_iter(x, *lw), s
        )

    return plan, v, jax.jit(init), run_n, jax.jit(
        zero_diag, donate_argnums=(0,)
    )


def sharded_simrank_spmm(
    g: Graph,
    mesh: Mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[ShardedTreePlan] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """Exact SimRank, sparse products, S sharded over the mesh.

    Same fixed point as ``exact_simrank_spmm`` (diag pinned during
    iteration, zeroed after — ``SimRank.java:27-30,62-65``), but no
    device ever holds more than a [V, V/n_dev] block of S or an
    O(E/n_dev) slice of P.  All ``cfg.iterations`` run inside ONE jitted
    ``fori_loop`` call — no per-iteration host dispatch.  Returns the
    [V, V] result (column-sharded NamedSharding; index/np.asarray it to
    materialise on host).
    """
    n_dev = mesh.devices.size
    v_real = g.n_nodes
    plan, v, init, run_n, zero_diag = make_sharded_iter(
        g, mesh, cfg, weighted=weighted, width=width, plan=plan,
        dtype=dtype,
    )
    s = init(jnp.zeros((n_dev,), jnp.float32))
    s = run_n(s, cfg.iterations, *(plan.levels + plan.weights))
    s = zero_diag(s)
    return s[:v_real, :v_real]
