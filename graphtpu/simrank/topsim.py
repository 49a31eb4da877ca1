"""TopSim — deterministic-spreading single-walk SimRank.

Reference (``simrank/TopSim_singleSample.java:62-203``): per source, a
queue of budget-carrying paths.  A frontier path at node ``cur`` with
budget ``s``:

  * ``s >= degree`` — splits evenly: every neighbour gets a child path with
    budget s/degree (``:99-124``), deterministically;
  * else — draws ``ceil(s)`` random neighbours, each child carrying
    s/ceil(s) (``:126-149``).

At every even depth 2i the frontier contributes
``budget * C^i * deg(path[i]) / deg(path[2i])`` to ``sim[src][path[2i]]``
under the same first-meet palindrome test as UniWalk (``:167-218``).
This budget-splitting is byte-identical in spirit to the Giraph combined
message walk (``giraph/CombineBatchSingleWalkVertexReuse.mySendMsg
:139-161``: avg = count/degree to every edge + remainder singles to random
neighbours) — so this kernel *is* the distributed kernel.

Device form: the queue becomes a fixed-capacity walker-slot tensor per source
tile — paths [T, W, L+1] with per-slot budget [T, W].  Child expansion is a
prefix-sum slot assignment (segment expansion); the even-split branch reads
CSR neighbour ``rank`` directly, the sampled branch draws uniformly.  Slot
overflow beyond W drops mass (reported); W defaults to 2*sample+8 which is
a proven bound: sum(children) <= sum(mass) + #sampled-parents.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import TopSimConfig
from graphtpu.core.graph import Graph
from graphtpu.kernels.sampling import uniform_neighbor
from graphtpu.kernels.topk import segment_topk, topk_rows
from graphtpu.simrank.uniwalk import _first_meet_mask


def _expand_frontier(
    g: Graph,
    paths: jax.Array,   # [T, W, L]
    mass: jax.Array,    # [T, W]
    depth: int,
    key: jax.Array,
    enumerate_all: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One budget-splitting step; returns (paths', mass', dropped_mass[T]).

    ``enumerate_all``: full enumeration — every active parent splits over
    every edge regardless of its remaining mass
    (TopSim_Enumerate.java:101-129 drops the budget guard)."""
    t, w, _ = paths.shape
    cur = paths[:, :, depth]
    d = g.deg[jnp.maximum(cur, 0)]
    active = (mass > 0) & (cur >= 0) & (d > 0)
    split = active if enumerate_all else active & (mass >= d)
    nchild = jnp.where(
        split, d, jnp.ceil(mass).astype(jnp.int32)
    )
    nchild = jnp.where(active, nchild, 0)

    offs = jnp.cumsum(nchild, axis=1) - nchild  # exclusive prefix sum
    total = offs[:, -1] + nchild[:, -1]
    slots = jnp.arange(w)

    # parent of each output slot: last parent whose offs <= slot
    parent = jax.vmap(
        lambda o: jnp.searchsorted(o, slots, side="right")
    )(offs) - 1
    parent = jnp.clip(parent, 0, w - 1)
    rank = slots[None, :] - jnp.take_along_axis(offs, parent, axis=1)
    p_nchild = jnp.take_along_axis(nchild, parent, axis=1)
    valid = (slots[None, :] < total[:, None]) & (rank < p_nchild) & (rank >= 0)

    p_cur = jnp.take_along_axis(cur, parent, axis=1)
    p_mass = jnp.take_along_axis(mass, parent, axis=1)
    p_split = jnp.take_along_axis(split, parent, axis=1)

    # even-split children: neighbour `rank` of the parent's CSR row
    base = g.row_ptr[jnp.maximum(p_cur, 0)].astype(jnp.int32)
    split_node = g.col[
        jnp.minimum(base + rank.astype(jnp.int32), g.col.shape[0] - 1)
    ]
    # sampled children: independent uniform neighbour draws
    samp_node = uniform_neighbor(g, p_cur.reshape(-1), key).reshape(t, w)
    node = jnp.where(p_split, split_node, samp_node)
    node = jnp.where(valid, node, -1)
    child_mass = jnp.where(valid, p_mass / jnp.maximum(p_nchild, 1), 0.0)

    new_paths = jnp.take_along_axis(
        paths, parent[:, :, None], axis=1
    )
    new_paths = new_paths.at[:, :, depth + 1].set(node)
    new_paths = jnp.where(valid[:, :, None], new_paths, -1)
    dropped = mass.sum(axis=1) - child_mass.sum(axis=1)
    return new_paths, child_mass, dropped


def topsim_simrank(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
    dense: bool = False,
):
    """TopSim_singleSample for all (or given) sources.

    Returns (topk_values, topk_indices) or the dense [N, V] matrix.
    """
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    if sources is None:
        sources = np.arange(v, dtype=np.int32)
    sources = np.asarray(sources, dtype=np.int32)
    n = len(sources)
    tile = min(cfg.source_tile, n)
    if cfg.frontier_capacity:
        cap = cfg.frontier_capacity
    elif cfg.enumerate_all:
        # full enumeration: frontier = #length-t paths <= d_max^t; cap it
        # so a hub graph raises instead of allocating forever
        dmax = int(np.max(np.asarray(g.deg))) if g.n_nodes else 1
        cap = max(dmax, 1) ** (2 * cfg.step)
        if cap > (1 << 17):
            raise ValueError(
                f"enumerate_all frontier bound {cap} too large; set "
                "frontier_capacity explicitly (dropped mass is accepted)"
            )
    else:
        cap = 2 * math.ceil(cfg.sample) + 8
    length = 2 * cfg.step + 1

    def tile_items(src_tile: jax.Array, k: jax.Array):
        """[T, cap*step] (targets, vals) increment items per source."""
        paths = jnp.full((tile, cap, length), -1, jnp.int32)
        paths = paths.at[:, 0, 0].set(src_tile)
        mass = jnp.zeros((tile, cap), jnp.float32).at[:, 0].set(cfg.sample)
        deg = g.deg
        tgt_list, val_list = [], []
        for depth in range(2 * cfg.step):
            paths, mass, _ = _expand_frontier(
                g, paths, mass, depth, jax.random.fold_in(k, depth),
                enumerate_all=cfg.enumerate_all,
            )
            lvl = depth + 1
            if lvl % 2 == 0:
                i = lvl // 2
                inter = paths[:, :, i]
                target = paths[:, :, 2 * i]
                ok = (
                    (mass > 0)
                    & (target >= 0)
                    & (target != src_tile[:, None])
                    & _first_meet_mask(paths[:, :, : 2 * i + 1], i)
                )
                val = (
                    mass
                    * (cfg.c ** i)
                    * deg[jnp.maximum(inter, 0)].astype(jnp.float32)
                    / jnp.maximum(
                        deg[jnp.maximum(target, 0)], 1
                    ).astype(jnp.float32)
                )
                if cfg.normalize:
                    val = val / cfg.sample
                tgt_list.append(jnp.where(ok, target, -1))
                val_list.append(jnp.where(ok, val, 0.0))
        return (
            jnp.concatenate(tgt_list, axis=1),
            jnp.concatenate(val_list, axis=1),
        )

    @jax.jit
    def run_tile_topk(src_tile: jax.Array, k: jax.Array):
        # production path: sort-based segment top-k, zero scatters (a
        # dense [T, V] scatter-add tile serialises its colliding rows)
        targets, vals = tile_items(src_tile, k)
        return segment_topk(targets, vals, cfg.topk, v)

    @jax.jit
    def run_tile_dense(src_tile: jax.Array, k: jax.Array):
        # small-V debug path: materialise the [T, V] similarity tile
        targets, vals = tile_items(src_tile, k)
        sim = jnp.zeros((tile, v), jnp.float32)
        t_idx2 = jnp.broadcast_to(jnp.arange(tile)[:, None], targets.shape)
        sim = sim.at[t_idx2, jnp.maximum(targets, 0)].add(
            jnp.where(targets >= 0, vals, 0.0)
        )
        rows = jnp.arange(tile)
        sim = sim.at[rows, src_tile].set(0.0)
        vals_k, idx_k = topk_rows(sim, cfg.topk)
        return sim, vals_k, idx_k

    out_vals = np.zeros((n, cfg.topk), np.float32)
    out_idx = np.zeros((n, cfg.topk), np.int32)
    out_dense = np.zeros((n, v), np.float32) if dense else None
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        chunk = sources[lo:hi]
        if len(chunk) < tile:
            chunk = np.concatenate(
                [chunk, np.zeros(tile - len(chunk), np.int32)]
            )
        m = hi - lo
        if dense:
            sim, vals, idx = run_tile_dense(
                jnp.asarray(chunk), jax.random.fold_in(key, lo)
            )
            out_dense[lo:hi] = np.asarray(sim)[:m]
        else:
            vals, idx = run_tile_topk(
                jnp.asarray(chunk), jax.random.fold_in(key, lo)
            )
        out_vals[lo:hi] = np.asarray(vals)[:m]
        out_idx[lo:hi] = np.asarray(idx)[:m]
    if dense:
        return out_dense
    return out_vals, out_idx
