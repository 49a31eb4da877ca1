"""UniWalk — single-walk Monte-Carlo SimRank, batched on the device.

Reference estimator (``simrank/SingleRandomWalk.java:53-106``): per source
v, SAMPLE uniform walks of length 2*STEP; for step i, if the prefix
0..2i is *first-meet* (no palindromic collision: path[j] != path[2i-j]
for all j < i), add

    C^i * deg(path[i]) / deg(path[2i]) / SAMPLE     to  sim[v][path[2i]].

Device form: sources are processed in tiles (the batched-source-window idea of
``giraph/BatchSingleWalkVertex.java:108-133``); each tile generates a
[T, SAMPLE, 2*STEP+1] walk tensor with one scan, the first-meet test is a
triangular mask over step prefixes, and increments scatter-add into a
dense [T, V] tile that is immediately reduced to top-k and streamed out —
no dense V x V state ever exists.

Path reuse (``SingleRandomWalkOptimal2.java:49-64``,
``giraph/BatchSingleWalkVertexReuse.java:39-56``): one physical walk of
length (times-1)*stride + 2*STEP feeds every offset o as a fresh sample for
source path[o]; per-source sample counts are accumulated and normalised at
flush exactly like the Giraph sink (``CombineBatchSingleWalkVertexReuse
.java:79-94``).  Implemented dense-[V,V] for graphs that fit.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import UniWalkConfig
from graphtpu.core.graph import Graph
from graphtpu.kernels.topk import pair_topk_by_source, segment_sum_1d, topk_rows
from graphtpu.walks.walker import uniform_walks


def _first_meet_mask(walks: jax.Array, i: int) -> jax.Array:
    """first-meet for prefix 0..2i: all j<i have path[j] != path[2i-j].

    walks: [..., L]; returns bool[...].
    """
    ok = jnp.ones(walks.shape[:-1], bool)
    for j in range(i):
        ok &= walks[..., j] != walks[..., 2 * i - j]
    return ok


def _tile_items(
    deg: jax.Array, walks: jax.Array, step: int, c: float, sample: int
):
    """(targets [T, S*step], values [T, S*step]) increment items from
    [T, S, 2*step+1] walks; invalid items carry target -1.

    ``deg``: int32[V] global degrees (``Graph.deg`` or a sharded graph's
    replicated ``deg_global``)."""
    source = walks[:, :, 0]
    tgt_list, val_list = [], []
    for i in range(1, step + 1):
        inter = walks[:, :, i]
        target = walks[:, :, 2 * i]
        ok = (
            (target >= 0)
            & (target != source)
            & _first_meet_mask(walks, i)
        )
        val = (
            (c ** i)
            * deg[jnp.maximum(inter, 0)].astype(jnp.float32)
            / jnp.maximum(deg[jnp.maximum(target, 0)], 1).astype(jnp.float32)
            / sample
        )
        tgt_list.append(jnp.where(ok, target, -1))
        val_list.append(jnp.where(ok, val, 0.0))
    return (
        jnp.concatenate(tgt_list, axis=1),
        jnp.concatenate(val_list, axis=1),
    )


def _tile_increments(
    deg: jax.Array, n_nodes: int, walks: jax.Array, step: int, c: float, sample: int
) -> jax.Array:
    """[T, V] similarity tile from [T, S, 2*step+1] walks (dense path)."""
    t, s, _ = walks.shape
    targets, vals = _tile_items(deg, walks, step, c, sample)
    sim = jnp.zeros((t, n_nodes), jnp.float32)
    t_idx = jnp.broadcast_to(
        jnp.arange(t)[:, None], targets.shape
    )
    return sim.at[t_idx, jnp.maximum(targets, 0)].add(
        jnp.where(targets >= 0, vals, 0.0)
    )


@partial(jax.jit, static_argnames=("sample", "step", "c", "topk", "tile"))
def _uniwalk_tile_topk(g, src_tile, key, *, sample, step, c, topk, tile):
    """Scatter-free tile kernel (module-level jit: ONE compile per shape
    across every window of a sweep — the per-call closures this replaces
    recompiled at every window).  Diagonal exclusion happens in
    _tile_items (target != source)."""
    from graphtpu.kernels.topk import segment_topk

    starts = jnp.repeat(src_tile, sample)
    walks = uniform_walks(g, starts, 2 * step, key)
    walks = walks.reshape(tile, sample, 2 * step + 1)
    targets, vals = _tile_items(g.deg, walks, step, c, sample)
    return segment_topk(targets, vals, topk, g.n_nodes)


@partial(jax.jit, static_argnames=("sample", "step", "c", "topk", "tile"))
def _uniwalk_tile_dense(g, src_tile, key, *, sample, step, c, topk, tile):
    starts = jnp.repeat(src_tile, sample)
    walks = uniform_walks(g, starts, 2 * step, key)
    walks = walks.reshape(tile, sample, 2 * step + 1)
    sim = _tile_increments(g.deg, g.n_nodes, walks, step, c, sample)
    # sim(v,v) = 0 (compute() zeroes the diagonal, SingleRandomWalk.java:44)
    t_idx = jnp.arange(tile)
    sim = sim.at[t_idx, src_tile].set(0.0)
    vals, idx = topk_rows(sim, topk)
    return sim, vals, idx


def uniwalk_simrank(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
    dense: bool = False,
):
    """Compute UniWalk SimRank for all (or given) sources.

    Returns ``(topk_values [N, topk], topk_indices [N, topk])`` numpy
    arrays in source order, or the dense [N, V] matrix when ``dense``.
    """
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    if sources is None:
        sources = np.arange(v, dtype=np.int32)
    sources = np.asarray(sources, dtype=np.int32)
    n = len(sources)
    tile = min(cfg.source_tile, n)
    kw = dict(
        sample=cfg.sample, step=cfg.step, c=cfg.c, topk=cfg.topk, tile=tile
    )

    out_vals = np.zeros((n, cfg.topk), np.float32)
    out_idx = np.zeros((n, cfg.topk), np.int32)
    out_dense = np.zeros((n, v), np.float32) if dense else None
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        chunk = sources[lo:hi]
        if len(chunk) < tile:  # pad to keep a single compiled shape
            chunk = np.concatenate(
                [chunk, np.zeros(tile - len(chunk), np.int32)]
            )
        m = hi - lo
        if dense:
            sim, vals, idx = _uniwalk_tile_dense(
                g, jnp.asarray(chunk), jax.random.fold_in(key, lo), **kw
            )
            out_dense[lo:hi] = np.asarray(sim)[:m]
        else:
            vals, idx = _uniwalk_tile_topk(
                g, jnp.asarray(chunk), jax.random.fold_in(key, lo), **kw
            )
        out_vals[lo:hi] = np.asarray(vals)[:m]
        out_idx[lo:hi] = np.asarray(idx)[:m]
    if dense:
        return out_dense
    return out_vals, out_idx


def _reuse_items(deg: jax.Array, walks: jax.Array, step: int, c: float, times: int):
    """Flat (srcs, tgts, vals, sample_srcs) item stream from reuse walks.

    ``walks``: [B, 2*step + times]; offset ``o`` of each physical walk is a
    fresh sample whose source is ``path[o]``
    (``SingleRandomWalkOptimal2.java:49-64``).  ``srcs``/``tgts`` carry -1
    for filtered items; ``sample_srcs`` lists one entry per (walk, offset)
    live sample (-1 when dead) for the flush normalisation counts.
    ``deg``: int32[V] global degrees.
    """
    src_list, tgt_list, val_list, cnt_list = [], [], [], []
    for o in range(times):
        seg = walks[:, o : o + 2 * step + 1]
        src = seg[:, 0]
        live = src >= 0
        cnt_list.append(jnp.where(live, src, -1))
        for i in range(1, step + 1):
            inter = seg[:, i]
            target = seg[:, 2 * i]
            ok = (
                live
                & (target >= 0)
                & (target != src)
                & _first_meet_mask(seg, i)
            )
            val = (
                (c ** i)
                * deg[jnp.maximum(inter, 0)].astype(jnp.float32)
                / jnp.maximum(deg[jnp.maximum(target, 0)], 1).astype(
                    jnp.float32
                )
            )
            src_list.append(jnp.where(ok, src, -1))
            tgt_list.append(jnp.where(ok, target, -1))
            val_list.append(jnp.where(ok, val, 0.0))
    return (
        jnp.concatenate(src_list),
        jnp.concatenate(tgt_list),
        jnp.concatenate(val_list),
        jnp.concatenate(cnt_list),
    )


def uniwalk_simrank_reuse(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[jax.Array] = None,
    walks: Optional[jax.Array] = None,
) -> np.ndarray:
    """Path-reuse variant, dense [V, V] (small graphs).

    ``cfg.reuse_times`` offsets per physical walk; each node launches
    ``sample // reuse_times`` walkers; every offset position o becomes a
    fresh sample for source path[o], and each source's estimate is
    normalised by the number of samples it actually received (the Giraph
    flush normalisation).  ``walks`` may inject precomputed reuse walks
    ([B, 2*step + times]); at-scale callers should prefer
    :func:`uniwalk_simrank_reuse_topk` (no [V, V] state, no scatters).
    """
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    times = max(cfg.reuse_times, 1)
    walkers_per_node = max(cfg.sample // times, 1)
    length = 2 * cfg.step + (times - 1)
    starts = jnp.repeat(jnp.arange(v, dtype=jnp.int32), walkers_per_node)

    @jax.jit
    def run(walks):
        srcs, tgts, vals, cnt_src = _reuse_items(
            g.deg, walks, cfg.step, cfg.c, times
        )
        counts = segment_sum_1d(cnt_src, jnp.ones_like(cnt_src, jnp.float32), v)
        sim = jnp.zeros((v, v), jnp.float32)
        sim = sim.at[jnp.maximum(srcs, 0), jnp.maximum(tgts, 0)].add(
            jnp.where(srcs >= 0, vals, 0.0)
        )
        sim = sim / jnp.maximum(counts, 1.0)[:, None]
        return sim * (1 - jnp.eye(v, dtype=sim.dtype))

    if walks is None:
        walks = uniform_walks(g, starts, length, key)  # [B, length+1]
    return np.asarray(run(walks))


def uniwalk_simrank_reuse_topk(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[jax.Array] = None,
    walks: Optional[jax.Array] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter-free path-reuse UniWalk: (vals [V, topk], idx [V, topk]).

    Same estimator as :func:`uniwalk_simrank_reuse` but the accumulation is
    one sort-based :func:`pair_topk_by_source` over the flat item stream —
    no [V, V] buffer and no element-wise scatters, so it runs at any V
    (the production path; the dense form is a small-graph oracle).
    """
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    times = max(cfg.reuse_times, 1)
    walkers_per_node = max(cfg.sample // times, 1)
    length = 2 * cfg.step + (times - 1)
    starts = jnp.repeat(jnp.arange(v, dtype=jnp.int32), walkers_per_node)

    @jax.jit
    def run(walks):
        srcs, tgts, vals, cnt_src = _reuse_items(
            g.deg, walks, cfg.step, cfg.c, times
        )
        counts = segment_sum_1d(cnt_src, jnp.ones_like(cnt_src, jnp.float32), v)
        return pair_topk_by_source(
            srcs,
            tgts,
            vals,
            jnp.arange(v, dtype=jnp.int32),
            cfg.topk,
            counts=counts,
        )

    if walks is None:
        walks = uniform_walks(g, starts, length, key)
    vals, idx = run(walks)
    return np.asarray(vals), np.asarray(idx)
