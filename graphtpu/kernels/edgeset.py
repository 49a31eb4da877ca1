"""O(1) edge-membership probes — the node2vec bias's hot predicate.

The second-order bias rule needs ``edge(prev, x)`` per proposal
(``node2vec/src/node2vec.py:73`` — the reference asks networkx
``G.has_edge``).  Round-2 answered it with a per-proposal bisection of
prev's sorted CSR row: log2(max_degree) ~ 13 sequential gather rounds
over the [B, T] proposal panel, which made second-order walks ~100x
slower than first-order (gather-throughput bound).  This module replaces
the bisection with a constant-probe structure built host-side once per
graph:

* ``bitmap`` (small V): a V*V bit matrix packed into uint32 words.
  One gather + one bit test per probe.  Exact.  Used when the bitmap
  fits the byte budget (default 64 MB -> V <= ~23k; covers blog).
* ``cuckoo`` (any V): a cuckoo filter [Fan et al. 2014, public
  algorithm] with 1-slot buckets at <=25% load and a 32-bit fingerprint
  drawn from a second independent hash of (u, v).  Two gathers + two
  compares per probe.  False positives require a simultaneous collision
  of two independent 32-bit hashes of the pair — rate ~ E/2^64 per
  probe, i.e. exact for any statistical purpose (and errors are
  one-sided: a non-edge misread as an edge shifts that proposal's bias
  from 1/q to 1).

Both are immutable pytrees safe to close over or pass through jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph

_BITMAP_BYTE_BUDGET = 64 * 1024 * 1024


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """32-bit finalizer (murmur3-style avalanche), numpy uint32."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _mix32_jnp(x: jax.Array) -> jax.Array:
    x = x.astype(jnp.uint32)
    x ^= x >> jnp.uint32(16)
    x *= jnp.uint32(0x7FEB352D)
    x ^= x >> jnp.uint32(15)
    x *= jnp.uint32(0x846CA68B)
    x ^= x >> jnp.uint32(16)
    return x


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["words", "table"],
    meta_fields=["mode", "n_nodes", "mask"],
)
@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """Constant-probe membership structure over a graph's edge set."""

    words: Optional[jax.Array]  # bitmap mode: uint32[ceil(V*V/32)]
    table: Optional[jax.Array]  # cuckoo mode: uint32[m] fingerprints (0=empty)
    mode: str
    n_nodes: int
    mask: int  # cuckoo: m - 1


def _fingerprint_np(u: np.ndarray, v: np.ndarray):
    """(slot-hash, fingerprint) of pairs — two independent 32-bit hashes."""
    u = u.astype(np.uint32)
    v = v.astype(np.uint32)
    h = _mix32_np(u * np.uint32(2654435761) + v)
    fp = _mix32_np(v * np.uint32(0x85EBCA6B) + u) | np.uint32(1)
    return h, fp


def _fingerprint_jnp(u: jax.Array, v: jax.Array):
    u = u.astype(jnp.uint32)
    v = v.astype(jnp.uint32)
    h = _mix32_jnp(u * jnp.uint32(2654435761) + v)
    fp = _mix32_jnp(v * jnp.uint32(0x85EBCA6B) + u) | jnp.uint32(1)
    return h, fp


def _build_cuckoo(src: np.ndarray, dst: np.ndarray, m: int) -> np.ndarray:
    """Vectorised cuckoo-filter build; returns uint32[m] or None on failure.

    Alternate slot is ``idx ^ mix(fp)`` (partial-key cuckoo), so evicted
    occupants can be rehomed knowing only their stored fingerprint.
    """
    mask = np.uint32(m - 1)
    tbl = np.zeros(m, np.uint32)
    h, fp = _fingerprint_np(src, dst)
    idx = h & mask
    for _ in range(500):
        if idx.size == 0:
            return tbl
        # one winner per slot; duplicates with equal fp count as placed
        uniq, first = np.unique(idx, return_index=True)
        old = tbl[uniq]
        winner = fp[first]
        tbl[uniq] = winner
        placed = tbl[idx] == fp
        # evicted occupants reinsert at their alternate slot
        ev = (old != 0) & (old != winner)
        ev_fp = old[ev]
        ev_idx = uniq[ev] ^ (_mix32_np(ev_fp) & mask)
        # losers (same slot, different fp) retry at their alternate slot
        lose_fp = fp[~placed]
        lose_idx = idx[~placed] ^ (_mix32_np(lose_fp) & mask)
        fp = np.concatenate([ev_fp, lose_fp])
        idx = np.concatenate([ev_idx, lose_idx])
    return None


def build_edge_set(
    g: Graph, bitmap_byte_budget: int = _BITMAP_BYTE_BUDGET
) -> EdgeSet:
    """Host-side build from a concrete Graph (numpy reads of the CSR)."""
    from graphtpu.core.graph import host_csr

    # the construction-time host mirror: no device->host round trip
    row_ptr, col, _, deg = host_csr(g)
    col = np.asarray(col)
    row_ptr = np.asarray(row_ptr)
    deg = np.asarray(deg)
    v = g.n_nodes
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    dst = col.astype(np.int64)
    if v * v // 8 <= bitmap_byte_budget:
        bits = src * v + dst
        words = np.zeros((v * v + 31) // 32, np.uint32)
        np.bitwise_or.at(
            words, (bits >> 5).astype(np.int64),
            np.uint32(1) << (bits & 31).astype(np.uint32),
        )
        # numpy-backed: safe to build at trace time (jnp.asarray here would
        # return a tracer and leak through the cache); converted per use in
        # edge_set_contains, or device_put by the caller for hot paths
        return EdgeSet(
            words=words, table=None, mode="bitmap", n_nodes=v, mask=0,
        )
    m = 1 << max(4, int(np.ceil(np.log2(max(1, 4 * len(dst))))))
    for _ in range(4):
        tbl = _build_cuckoo(src, dst, m)
        if tbl is not None:
            return EdgeSet(
                words=None, table=tbl,
                mode="cuckoo", n_nodes=v, mask=m - 1,
            )
        m *= 2
    raise RuntimeError("cuckoo edge-set build failed to converge")


def edge_set_contains(es: EdgeSet, u: jax.Array, v: jax.Array) -> jax.Array:
    """bool per pair (broadcasting): is (u, v) an edge?  Invalid ids (<0)
    are never members."""
    u, v = jnp.broadcast_arrays(u, v)
    valid = (u >= 0) & (v >= 0)
    us = jnp.maximum(u, 0)
    vs = jnp.maximum(v, 0)
    if es.mode == "bitmap":
        words = jnp.asarray(es.words)
        bits = us.astype(jnp.int32) * es.n_nodes + vs.astype(jnp.int32)
        word = words[bits >> 5]
        hit = (word >> (bits & 31).astype(jnp.uint32)) & jnp.uint32(1)
        return (hit != 0) & valid
    h, fp = _fingerprint_jnp(us, vs)
    mask = jnp.uint32(es.mask)
    i1 = (h & mask).astype(jnp.int32)
    i2 = (i1.astype(jnp.uint32) ^ (_mix32_jnp(fp) & mask)).astype(jnp.int32)
    table = jnp.asarray(es.table)
    hit = (table[i1] == fp) | (table[i2] == fp)
    return hit & valid


def device_edge_set(g: Graph) -> EdgeSet:
    """The cached edge set with its tables device_put — pass THIS as a jit
    argument on hot paths so the table uploads once, not per call."""
    key = ("dev", id(g.col), g.n_nodes, g.n_edges)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is g.col:
        return hit[1]
    es = jax.device_put(edge_set(g))
    _CACHE[key] = (g.col, es)
    return es


_CACHE: dict = {}


def edge_set(g: Graph) -> EdgeSet:
    """Per-graph cached edge set.  Requires a concrete (non-traced) graph;
    inside jit, build it outside and pass it in."""
    key = (id(g.col), g.n_nodes, g.n_edges)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is g.col:
        return hit[1]
    if isinstance(g.col, jax.core.Tracer):
        raise TypeError(
            "edge_set(g) needs a concrete graph; build_edge_set outside jit "
            "and pass the EdgeSet through."
        )
    es = build_edge_set(g)
    if len(_CACHE) > 16:
        _CACHE.clear()
    _CACHE[key] = (g.col, es)
    return es
