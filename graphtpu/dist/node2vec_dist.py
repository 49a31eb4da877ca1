"""Distributed second-order (p, q)-biased walks on a partitioned CSR.

The reference's main walk product is node2vec's second-order walker
(``node2vec/src/node2vec.py:61-81``); its Giraph walkers hop by vertex
message (``giraph/SingleWalkVertex.java:66-89``).  On a partitioned graph
the second-order bias needs TWO rows per hop: cur's row (to propose) and
prev's row (the triangle test ``edge(prev, x)``).  Those rows live on
different owners, so each hop ships the edge-exists probe with the
exchange:

  1. route walkers (wid, prev, cur) to owner(cur) — propose a T-panel of
     neighbours from the LOCAL CSR block (rejection sampling, the same
     panel scheme as :mod:`graphtpu.walks.node2vec`);
  2. route (wid, prev, proposals) to owner(prev) — answer the membership
     probes against prev's LOCAL row (sorted-CSR bisection), compute the
     bias, accept the first surviving proposal;
  3. route (wid, next) back to the walker's home shard.

Three ``all_to_all`` per hop; no device ever holds a remote row.  With a
replicated :class:`Graph` use the single-chip walker instead — this
module exists for graphs that don't fit one worker.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from graphtpu.dist.frontier import exchange_by_owner
from graphtpu.dist.sharded_graph import ShardedGraph, local_graph
from graphtpu.kernels.sampling import (
    edge_exists,
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)
from graphtpu.walks.node2vec import default_max_trials


def distributed_node2vec_walks(
    g: ShardedGraph,
    n_walkers: int,
    num_steps: int,
    p: float,
    q: float,
    key: jax.Array,
    mesh: Mesh,
    starts: Optional[jax.Array] = None,
    max_trials: Optional[int] = None,
    weighted: bool = False,
) -> jax.Array:
    """int32[n_walkers, num_steps+1]; first hop first-order, later hops
    second-order — the distributed analog of
    :func:`graphtpu.walks.node2vec.node2vec_walks` (statistical parity,
    independent RNG streams)."""
    assert isinstance(g, ShardedGraph)
    inv_p, inv_q = 1.0 / p, 1.0 / q
    qmax = max(inv_p, 1.0, inv_q)
    t = max_trials if max_trials is not None else default_max_trials(p, q)
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    assert n_walkers % n_dev == 0
    per_dev = n_walkers // n_dev
    nodes_per = g.nodes_per
    use_w = weighted and g.weight is not None
    if starts is None:
        starts = jax.random.randint(
            key, (n_walkers,), 0, g.n_nodes, dtype=jnp.int32
        )
    wid = jnp.arange(n_walkers, dtype=jnp.int32)
    from graphtpu.dist.frontier import narrowest_int_dtype

    # byte/short-packed wire formats (BatchSingleWalkVertex_Byte.java)
    wd_wid = narrowest_int_dtype(n_walkers - 1)
    wd_node = narrowest_int_dtype(g.n_nodes - 1)
    w_spec = (P(axis, None),) if use_w else ()

    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(),
            P(axis, None), P(axis, None), P(axis, None),
        ) + w_spec,
        out_specs=P(axis),
    )
    def run(starts_l, wid_l, key_r, rp_b, col_b, deg_b, *w_b):
        me = jax.lax.axis_index(axis)
        g_loc = local_graph(
            rp_b, col_b, deg_b, g.max_degree,
            weight_blk=w_b[0] if w_b else None,
        )
        cumw = row_cumulative_weights(g_loc) if use_w else None
        kdev = jax.random.fold_in(key_r[0], me)

        walks = jnp.full((per_dev, num_steps + 1), -1, jnp.int32)
        walks = walks.at[:, 0].set(starts_l)

        def sample_local(loc, ks, shape_t=None):
            if shape_t is None:
                if use_w:
                    return weighted_neighbor(g_loc, cumw, loc, ks)
                return uniform_neighbor(g_loc, loc, ks)
            locw = jnp.broadcast_to(loc[:, None], (loc.shape[0], shape_t))
            if use_w:
                return weighted_neighbor(g_loc, cumw, locw, ks)
            return uniform_neighbor(g_loc, locw, ks)

        def route_home(r_wid, nxt, walks, step_idx):
            home = jnp.where(r_wid >= 0, r_wid // per_dev, -1)
            (h_wid, h_nxt), _ = exchange_by_owner(
                (r_wid, nxt), home, axis, n_dev, per_dev,
                wire_dtypes=(wd_wid, wd_node),
            )
            slot = jnp.where(h_wid >= 0, h_wid % per_dev, per_dev)
            return walks.at[slot, step_idx].set(h_nxt, mode="drop")

        # hop 1: first-order (alias_nodes semantics, node2vec.py:28-29)
        cur = walks[:, 0]
        owner = jnp.where(cur >= 0, cur // nodes_per, -1)
        (r_wid, r_cur), _ = exchange_by_owner(
            (wid_l, cur), owner, axis, n_dev, per_dev,
            wire_dtypes=(wd_wid, wd_node),
        )
        kdev, ks = jax.random.split(kdev)
        loc = jnp.where(r_cur >= 0, r_cur - me * nodes_per, -1)
        nxt = sample_local(loc, ks)
        walks = route_home(r_wid, nxt, walks, 1)

        def hop(s, carry):
            walks, kdev = carry
            prev = jnp.take_along_axis(walks, s[None, None] - 1, axis=1)[:, 0]
            cur = jnp.take_along_axis(walks, s[None, None], axis=1)[:, 0]
            ok = cur >= 0
            owner = jnp.where(ok, cur // nodes_per, -1)
            # (1) propose a T-panel at cur's owner
            (r_wid, r_prev, r_cur), _ = exchange_by_owner(
                (jnp.where(ok, wid_l, -1), prev, cur),
                owner, axis, n_dev, per_dev,
                wire_dtypes=(wd_wid, wd_node, wd_node),
            )
            kdev, ks = jax.random.split(kdev)
            loc = jnp.where(r_cur >= 0, r_cur - me * nodes_per, -1)
            props = sample_local(loc, ks, shape_t=t)  # [N, T] global ids
            # (2) ship the probes to prev's owner
            powner = jnp.where(
                (r_wid >= 0) & (r_prev >= 0), r_prev // nodes_per, -1
            )
            # a cur-owner can hold every walker (n_dev*per_dev) and they
            # may all share one prev-owner (e.g. a common start node), so
            # the probe buckets must be full-width
            payloads = (r_wid, r_prev) + tuple(props[:, j] for j in range(t))
            recv, valid = exchange_by_owner(
                payloads, powner, axis, n_dev, n_dev * per_dev,
                wire_dtypes=(wd_wid,) + (wd_node,) * (len(payloads) - 1),
            )
            q_wid, q_prev = recv[0], recv[1]
            q_props = jnp.stack(recv[2:], axis=1)  # [N, T]
            ploc = jnp.where(q_prev >= 0, q_prev - me * nodes_per, -1)
            is_ret = q_props == q_prev[:, None]
            is_tri = edge_exists(g_loc, ploc[:, None], q_props)
            bias = jnp.where(is_ret, inv_p, jnp.where(is_tri, 1.0, inv_q))
            kdev, ka = jax.random.split(kdev)
            acc = jax.random.uniform(ka, q_props.shape) < (bias / qmax)
            acc = acc | (q_props < 0)
            first = jnp.argmax(acc, axis=1)
            idx = jnp.where(acc.any(axis=1), first, t - 1)
            nxt = jnp.take_along_axis(q_props, idx[:, None], axis=1)[:, 0]
            nxt = jnp.where(q_wid >= 0, nxt, -1)
            # (3) home
            walks = route_home(q_wid, nxt, walks, s + 1)
            return walks, kdev

        walks, _ = jax.lax.fori_loop(1, num_steps, hop, (walks, kdev))
        return walks

    args = (starts, wid, jnp.stack([key]), g.row_ptr, g.col, g.deg)
    if use_w:
        args += (g.weight,)
    return run(*args)
