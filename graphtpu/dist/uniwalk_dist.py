"""Distributed UniWalk SimRank — the ``giraph/SingleWalkVertex`` analog.

Reference flow (``giraph/SingleWalkVertex.java:66-89``): every vertex emits
SAMPLE walker messages; each superstep walkers hop via vertex messages,
and at even steps a similarity-increment message is sent back to the
source, accumulated in a bounded map.  Batched-window variants flush
per-window results (``BatchSingleWalkVertex.java:108-133``).

Device mapping: sources are sharded over the mesh ('data' axis = the Giraph
worker partition); walkers route between node owners with the
:mod:`graphtpu.dist.frontier` all_to_all exchange (one jitted superstep
per hop); each home shard then computes its sources' first-meet increments
locally and reduces straight to top-k — the flush.  Combine with
:func:`graphtpu.dist.windows.windowed_topk_sweep` for the batch-window +
checkpoint behaviour.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.config import UniWalkConfig
from graphtpu.core.graph import Graph
from graphtpu.dist.frontier import distributed_uniform_walks, exchange_by_owner
from graphtpu.dist.sharded_graph import ShardedGraph
from graphtpu.kernels.topk import (
    pair_topk_by_source,
    segment_sum_1d,
    segment_topk,
)
from graphtpu.simrank.uniwalk import (
    _first_meet_mask,
    _reuse_items,
    _tile_items,
)


def _global_deg(g) -> jax.Array:
    """int32[>=V] degree lookup valid for any node id (replicated O(V))."""
    return g.deg_global if isinstance(g, ShardedGraph) else g.deg


def distributed_uniwalk_simrank(
    g,
    mesh: Mesh,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
    max_walk_ints: int = 256 * 1024 * 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """(topk values, topk indices) for the given sources (default: all).

    ``g``: replicated :class:`Graph` or partitioned :class:`ShardedGraph`
    (each device then walks against only its local CSR block).

    Sources are padded to a multiple of the mesh size; each device owns a
    contiguous source block (its "worker partition") and the walk frontier
    is exchanged by node ownership every hop.  The walk tensor is bounded
    at ``max_walk_ints`` int32s across the mesh: larger jobs loop over
    internal source windows (the BATCH semantics,
    ``SingleWalkMasterCompute.java:29-35``), so the entry has no hidden
    replicated-scale ceiling.
    """
    if key is None:
        key = jax.random.key(0)
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    if sources is None:
        sources = np.arange(g.n_nodes, dtype=np.int32)
    sources = np.asarray(sources, np.int32)
    n = len(sources)

    per_src_ints = cfg.sample * (2 * cfg.step + 1)
    if n * per_src_ints > max_walk_ints and n > n_dev:
        win = max(n_dev, (max_walk_ints // per_src_ints) // n_dev * n_dev)
        vs, is_ = [], []
        for lo in range(0, n, win):
            v_w, i_w = distributed_uniwalk_simrank(
                g, mesh, cfg, key=jax.random.fold_in(key, lo),
                sources=sources[lo : lo + win],
                max_walk_ints=max_walk_ints,
            )
            vs.append(v_w)
            is_.append(i_w)
        return np.concatenate(vs), np.concatenate(is_)
    pad = (-n) % n_dev
    src_p = np.concatenate([sources, np.zeros(pad, np.int32)]) if pad else sources
    n_p = len(src_p)

    starts = jnp.repeat(jnp.asarray(src_p), cfg.sample)
    walks = distributed_uniform_walks(
        g,
        n_walkers=n_p * cfg.sample,
        num_steps=2 * cfg.step,
        key=key,
        mesh=mesh,
        starts=starts,
    )  # [n_p * S, 2*step+1], row-sharded over the mesh

    shard = NamedSharding(mesh, P(axis))
    row_shard = NamedSharding(mesh, P(axis, None))
    deg = _global_deg(g)

    @partial(jax.jit, out_shardings=(row_shard, row_shard))
    def flush(walks, src):
        w = walks.reshape(n_p, cfg.sample, 2 * cfg.step + 1)
        w = jax.lax.with_sharding_constraint(
            w, NamedSharding(mesh, P(axis, None, None))
        )
        # scatter-free: flat items -> sort-based per-source top-k; the
        # diagonal is excluded in _tile_items (target != source), matching
        # compute() zeroing it (SingleRandomWalk.java:44)
        targets, vals = _tile_items(deg, w, cfg.step, cfg.c, cfg.sample)
        return segment_topk(targets, vals, cfg.topk, g.n_nodes)

    vals, idx = flush(walks, jax.device_put(jnp.asarray(src_p), shard))
    return np.asarray(vals)[:n], np.asarray(idx)[:n]


def distributed_uniwalk_simrank_reuse(
    g,
    mesh: Mesh,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[jax.Array] = None,
    walks: Optional[jax.Array] = None,
    route_slack: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Distributed path-reuse UniWalk — the
    ``giraph/BatchSingleWalkVertexReuse`` analog (TIMES offsets per
    physical walk, ``BatchSingleWalkVertexReuse.java:39-56``).

    Every node launches ``sample // reuse_times`` walkers of length
    ``2*step + reuse_times - 1``; offset ``o`` of each walk is a fresh
    sample whose *source* is ``path[o]`` — an arbitrary node, so (as in
    Giraph, where sim-increment messages are routed to the source's
    owner) increments must cross shards.  The device mapping builds each
    device's flat (src, tgt, val) item stream, routes items home with ONE
    ``all_to_all`` (the Giraph sim-message routing), and reduces each
    shard's received items straight to top-k with the sort-based
    :func:`pair_topk_by_source` — no [V, V] buffer anywhere, so every
    shard holds O(items + V/n_dev · topk) state and the path scales to
    the reference's 1M/10M-vertex regime
    (``BatchSingleWalkVertex_Byte.java:38-41``).

    ``route_slack`` sizes the per-owner exchange buckets at
    ``slack × fair_share``; overflow drops items (Giraph heap sizing) —
    the returned ``dropped`` count is asserted zero by tests.
    ``walks`` may inject precomputed reuse walks ([B, 2*step+times],
    B divisible by the mesh size) for parity testing.

    Returns (vals, idx), each [V, topk].
    """
    if key is None:
        key = jax.random.key(0)
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    v = g.n_nodes
    v_p = v + ((-v) % n_dev)
    times = max(cfg.reuse_times, 1)
    wpn = max(cfg.sample // times, 1)
    length = 2 * cfg.step + (times - 1)

    if walks is None:
        starts = np.repeat(np.arange(v, dtype=np.int32), wpn)
        pad = (-len(starts)) % n_dev
        if pad:
            # dead walkers: never routed, their rows stay -1 everywhere
            starts = np.concatenate([starts, np.full(pad, -1, np.int32)])
        walks = distributed_uniform_walks(
            g,
            n_walkers=len(starts),
            num_steps=length,
            key=key,
            mesh=mesh,
            starts=jnp.asarray(starts),
        )  # [B, length+1], row-sharded over the walker axis
    n_walkers = walks.shape[0]
    assert n_walkers % n_dev == 0

    from jax import shard_map

    rows_per = v_p // n_dev
    from graphtpu.dist.frontier import narrowest_int_dtype

    wd_node = narrowest_int_dtype(v_p - 1)
    deg = _global_deg(g)
    items_local = (n_walkers // n_dev) * times * cfg.step
    # Bucket capacity is per (sender, owner) pair.  Offset-0 sources are
    # the walk starts, which live on their OWN owner shard when starts are
    # node-partition aligned (the windowed/default layout) — so the self
    # bucket carries ~items/times deterministically; the remaining offsets
    # mix toward uniform and get slack × fair-share.  Overflow raises.
    capacity = int(
        math.ceil(items_local / max(times, 1))
        + max(64, math.ceil(items_local / n_dev * route_slack))
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=(P(axis, None), P(axis, None), P()),
    )
    def flush(walks_l):
        srcs, tgts, vals, cnt_src = _reuse_items(
            deg, walks_l, cfg.step, cfg.c, times
        )
        counts = segment_sum_1d(
            cnt_src, jnp.ones_like(cnt_src, jnp.float32), v_p
        )
        counts = jax.lax.psum(counts, axis)
        owner = jnp.where(srcs >= 0, srcs // rows_per, -1)
        # overflow diagnostic: items beyond an owner bucket's capacity drop
        per_owner = segment_sum_1d(
            owner, jnp.ones_like(owner, jnp.float32), n_dev
        )
        dropped = jax.lax.psum(
            jnp.maximum(per_owner - capacity, 0.0).sum(), axis
        )
        (r_src, r_tgt, r_val), _ = exchange_by_owner(
            (srcs, tgts, vals), owner, axis, n_dev, capacity,
            # short-packed ids when V fits (Short_2MixMsgWritable.java);
            # sim values stay f32 on the wire (exactness tests compare
            # against the single-device trajectory bit-for-bit)
            wire_dtypes=(wd_node, wd_node, None),
        )
        me = jax.lax.axis_index(axis)
        local_ids = me * rows_per + jnp.arange(rows_per, dtype=jnp.int32)
        gv, gi = pair_topk_by_source(
            r_src.astype(jnp.int32),
            r_tgt.astype(jnp.int32),
            r_val,
            local_ids,
            cfg.topk,
            counts=counts,
        )
        return gv, gi, dropped[None]

    vals, idx, dropped = jax.jit(flush)(walks)
    n_dropped = float(np.asarray(dropped)[0])
    if n_dropped > 0:
        raise RuntimeError(
            f"reuse flush dropped {n_dropped:.0f} items; raise route_slack "
            f"(capacity={capacity})"
        )
    return np.asarray(vals)[:v], np.asarray(idx)[:v]
