"""Frontier exchange — the BSP message-routing primitive.

In the reference, walkers move between machines as Giraph vertex messages
with a global superstep barrier (``giraph/SingleWalkVertex.java:66-89``;
netty RPC + ZooKeeper).  The accelerator equivalent (SURVEY.md §5) is a
single collective per superstep: walkers are bucketed by owner device and
exchanged with ``all_to_all`` over the interconnect, fixed-capacity buckets keeping
shapes static.  This is the framework's CP/ring analog — any algorithm
that sends per-node state (walker frontiers, sim increments, TopSim mass)
across a partitioned graph goes through :func:`exchange_by_owner`.

``distributed_uniform_walks`` demonstrates the full Giraph walk flow on a
mesh: route walkers to the owner of their current node, step there, route
results back to the walker's home shard — one jitted superstep per hop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.graph import Graph
from graphtpu.kernels.sampling import (
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)


def narrowest_int_dtype(max_value: int):
    """Narrowest SIGNED int dtype holding [-1, max_value] — the wire
    format picker.  The reference's 1M-vertex run works because walker
    messages are byte/short-packed (``giraph/BatchSingleWalkVertex_Byte
    .java:38-51``, ``writables/Short_2MixMsgWritable.java``,
    ``writables/ByteArrayWritable.java``); here the analogous lever is
    shipping ``all_to_all`` buckets in int8/int16 when the id range fits,
    cutting interconnect bytes 2-4x on the comm-bound distributed walks."""
    if max_value < 2**7:
        return jnp.int8
    if max_value < 2**15:
        return jnp.int16
    return jnp.int32


# trace-time accounting of collective payload bytes: shapes are static
# under jit, so one trace records the exact bytes every execution moves
# (the LogProcess.extractMsg analog, counted directly instead of mined
# from logs).
_wire_stats = {"bytes": 0, "bytes_unpacked": 0, "exchanges": 0}


def reset_wire_stats() -> None:
    _wire_stats.update(bytes=0, bytes_unpacked=0, exchanges=0)


def wire_stats() -> dict:
    return dict(_wire_stats)


def _bucket_route(owner: jax.Array, n_dev: int, capacity: int):
    """Shared routing computation for one exchange: the stable owner
    sort, per-owner ranks, and validity — computed ONCE and applied to
    every payload (the node2vec hop ships ~20 payloads per exchange;
    re-sorting per payload cost 20 identical argsorts)."""
    n = owner.shape[0]
    owner_c = jnp.where(owner < 0, n_dev, owner)
    order = jnp.argsort(owner_c)  # stable: preserves arrival order
    sorted_owner = owner_c[order]
    idx = jnp.arange(n)
    start = jnp.searchsorted(sorted_owner, jnp.arange(n_dev + 1))
    rank = idx - start[jnp.minimum(sorted_owner, n_dev)]
    ok = (sorted_owner < n_dev) & (rank < capacity)
    rows = jnp.where(ok, sorted_owner, n_dev)
    cols = jnp.where(ok, rank, 0)
    return order, rows, cols


def _pack_buckets_routed(
    payload: jax.Array, route, n_dev: int, capacity: int, fill
) -> jax.Array:
    order, rows, cols = route
    buckets = jnp.full((n_dev, capacity), fill, payload.dtype)
    # invalid entries scatter out of bounds and are dropped
    return buckets.at[rows, cols].set(payload[order], mode="drop")


def _pack_buckets(
    payload: jax.Array, owner: jax.Array, n_dev: int, capacity: int, fill
) -> jax.Array:
    """[N] payload -> [n_dev, capacity] buckets by owner (overflow drops).

    Owner < 0 marks invalid entries (dropped).
    """
    return _pack_buckets_routed(
        payload, _bucket_route(owner, n_dev, capacity), n_dev, capacity,
        fill,
    )


def exchange_by_owner(
    payloads: Tuple[jax.Array, ...],
    owner: jax.Array,
    axis_name: str,
    n_dev: int,
    capacity: int,
    fill: int = -1,
    wire_dtypes: Optional[Tuple] = None,
) -> Tuple[Tuple[jax.Array, ...], jax.Array]:
    """Inside shard_map: route [N]-rows to their owner device.

    Returns (received payloads, each [n_dev * capacity]) plus a validity
    mask; entries that overflowed a bucket are dropped (callers size
    ``capacity`` so this cannot happen in practice, as the reference sizes
    Giraph heaps).

    ``wire_dtypes``: per-payload wire format (None entries keep the
    payload dtype).  Integer payloads whose range fits are shipped as
    int8/int16 and widened back after the collective; float payloads may
    ship as bfloat16 (accumulation stays f32 at the destination).  This
    is the byte/short-packed-writables optimization of the reference's
    giraph backend (``BatchSingleWalkVertex_Byte.java:38-51``) in its
    device form — the packing is a pair of converts XLA fuses into
    the bucket scatter/gather, only the ``all_to_all`` moves fewer bytes.
    """
    if wire_dtypes is None:
        wire_dtypes = (None,) * len(payloads)
    assert len(wire_dtypes) == len(payloads)
    route = _bucket_route(owner, n_dev, capacity)
    order, rows, cols = route

    # group payloads by WIRE dtype and ship each group as ONE stacked
    # all_to_all — the node2vec hop carries ~20 same-dtype probe columns,
    # and per-payload collectives cost ~20 launches where 2 suffice
    groups: dict = {}
    for i, (pay, wd) in enumerate(zip(payloads, wire_dtypes)):
        orig = pay.dtype
        wire = jnp.dtype(wd) if wd is not None else orig
        groups.setdefault((wire, orig), []).append(i)

    outs: list = [None] * len(payloads)
    for (wire, orig), idxs in groups.items():
        stacked = jnp.stack(
            [payloads[i].astype(wire) for i in idxs], axis=-1
        )                                        # [N, k]
        k = len(idxs)
        buckets = jnp.full((n_dev, capacity, k), fill, wire)
        buckets = buckets.at[rows, cols].set(
            stacked[order], mode="drop"
        )
        _wire_stats["bytes"] += buckets.size * buckets.dtype.itemsize
        _wire_stats["bytes_unpacked"] += buckets.size * jnp.dtype(
            orig
        ).itemsize
        recv = jax.lax.all_to_all(
            buckets, axis_name, split_axis=0, concat_axis=0, tiled=False
        )                                        # [n_dev, capacity, k]
        recv = recv.reshape(-1, k).astype(orig)
        for j, i in enumerate(idxs):
            outs[i] = recv[:, j]
    _wire_stats["exchanges"] += 1
    valid = outs[0] != fill if outs else None
    return tuple(outs), valid


def distributed_uniform_walks(
    g,
    n_walkers: int,
    num_steps: int,
    key: jax.Array,
    mesh: Mesh,
    starts: Optional[jax.Array] = None,
    weighted: bool = False,
) -> jax.Array:
    """[n_walkers, num_steps+1] walk tensor via per-superstep all_to_all.

    Node ownership is by contiguous range (edge partition by source-node
    range per host, SURVEY.md §7.8); each walker lives on a home shard that
    assembles its path.  One hop = route to owner -> sample -> route home,
    exactly the Giraph message cycle, as two all_to_all collectives.

    ``g`` may be a replicated :class:`Graph` or a
    :class:`~graphtpu.dist.sharded_graph.ShardedGraph`; with a sharded
    graph each device samples against ONLY its local CSR block after the
    owner exchange — the full adjacency never exists on any one device
    (the Giraph property, ``giraph/SingleWalkVertex.java:66-89``).  With
    the same key both forms produce identical walks: routing, bucket
    order, and per-owner RNG streams are shared, only where the CSR rows
    are read from differs.
    """
    from graphtpu.dist.sharded_graph import ShardedGraph, local_graph

    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    assert n_walkers % n_dev == 0
    per_dev = n_walkers // n_dev
    sharded = isinstance(g, ShardedGraph)
    nodes_per_dev = g.nodes_per if sharded else -(-g.n_nodes // n_dev)
    if starts is None:
        starts = jax.random.randint(
            key, (n_walkers,), 0, g.n_nodes, dtype=jnp.int32
        )
    wid = jnp.arange(n_walkers, dtype=jnp.int32)
    # byte/short-packed wire formats when the id ranges fit
    # (BatchSingleWalkVertex_Byte.java:38-51)
    wd_wid = narrowest_int_dtype(n_walkers - 1)
    wd_node = narrowest_int_dtype(g.n_nodes - 1)

    from jax import shard_map

    def loop(starts_l, wid_l, key_r, sample_at_owner):
        me = jax.lax.axis_index(axis)
        kdev = jax.random.fold_in(key_r[0], me)
        walks = jnp.full((per_dev, num_steps + 1), -1, jnp.int32)
        walks = walks.at[:, 0].set(starts_l)

        def step(t, carry):
            walks, kdev = carry
            cur = walks[:, t]
            owner = jnp.where(cur >= 0, cur // nodes_per_dev, -1)
            # route (walker id, node) to the node's owner
            (r_wid, r_cur), _ = exchange_by_owner(
                (wid_l, cur), owner, axis, n_dev, per_dev,
                wire_dtypes=(wd_wid, wd_node),
            )
            kdev, ks = jax.random.split(kdev)
            nxt = sample_at_owner(me, r_cur, ks)
            # route the result back to the walker's home shard
            home = jnp.where(r_wid >= 0, r_wid // per_dev, -1)
            (h_wid, h_nxt), _ = exchange_by_owner(
                (r_wid, nxt), home, axis, n_dev, per_dev,
                wire_dtypes=(wd_wid, wd_node),
            )
            slot = jnp.where(h_wid >= 0, h_wid % per_dev, per_dev)
            walks = walks.at[slot, t + 1].set(h_nxt, mode="drop")
            return walks, kdev

        walks, _ = jax.lax.fori_loop(0, num_steps, step, (walks, kdev))
        return walks

    use_w = weighted and g.weight is not None
    if sharded:
        w_spec = (P(axis, None),) if use_w else ()

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                P(axis),
                P(axis),
                P(),
                P(axis, None),
                P(axis, None),
                P(axis, None),
            ) + w_spec,
            out_specs=P(axis),
        )
        def run_sharded(starts_l, wid_l, key_r, rp_b, col_b, deg_b, *w_b):
            g_loc = local_graph(
                rp_b, col_b, deg_b, g.max_degree,
                weight_blk=w_b[0] if w_b else None,
            )
            cumw = row_cumulative_weights(g_loc) if use_w else None

            def sample(me, r_cur, ks):
                # owner-local ids: every routed walker's node is ours
                loc = jnp.where(r_cur >= 0, r_cur - me * nodes_per_dev, -1)
                if use_w:
                    return weighted_neighbor(g_loc, cumw, loc, ks)
                return uniform_neighbor(g_loc, loc, ks)

            return loop(starts_l, wid_l, key_r, sample)

        args = (starts, wid, jnp.stack([key]), g.row_ptr, g.col, g.deg)
        if use_w:
            args += (g.weight,)
        return run_sharded(*args)

    cumw_g = row_cumulative_weights(g) if use_w else None

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    def run(starts_l, wid_l, key_r):
        def sample(me, r_cur, ks):
            if use_w:
                return weighted_neighbor(g, cumw_g, r_cur, ks)
            return uniform_neighbor(g, r_cur, ks)

        return loop(starts_l, wid_l, key_r, sample)

    return run(starts, wid, jnp.stack([key]))
