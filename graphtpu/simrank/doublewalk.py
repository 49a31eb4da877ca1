"""Double-walk Monte-Carlo SimRank.

Reference (``simrank/DoubleRandomWalk.java:50-91``): pre-sample SAMPLE
walks of STEP hops per node (``paths[v][s][t]`` = node after t+1 hops);
sim(v,w) = (1/SAMPLE^2) * sum over all walk pairs of C^(t+1), where t is
the *first* step at which the two walks coincide (the scan breaks at the
first -1 or first meeting).

Device form: all walks are one [V, S, STEP] tensor from a single batched
scan.  The pairing loop becomes a blocked computation: for a (T1, T2)
source-pair tile, equality tensors eq_t = (paths_i[:,None,:,None,t] ==
paths_j[None,:,None,:,t]) are combined with a carried "already met" mask —
first-meet weights sum exactly as the reference's break semantics
(walks never revive after -1, so "-1 never equals anything" reproduces the
break).  O(V^2 S^2 STEP) like the reference, but on the VPU.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import DoubleWalkConfig
from graphtpu.core.graph import Graph
from graphtpu.walks.walker import uniform_walks


def sample_double_walk_paths(
    g: Graph, sample: int, step: int, key: jax.Array
) -> jax.Array:
    """int32[V, SAMPLE, STEP]: node after t+1 hops (-1 once dead)."""
    v = g.n_nodes
    starts = jnp.repeat(jnp.arange(v, dtype=jnp.int32), sample)
    walks = uniform_walks(g, starts, step, key)  # [V*S, STEP+1]
    return walks[:, 1:].reshape(v, sample, step)


def doublewalk_simrank(
    g: Graph,
    cfg: DoubleWalkConfig = DoubleWalkConfig(),
    key: Optional[jax.Array] = None,
) -> np.ndarray:
    """Dense [V, V] similarity (diag zeroed), reference estimator."""
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    paths = sample_double_walk_paths(g, cfg.sample, cfg.step, key)
    tile = min(cfg.source_tile, v)
    n_tiles = -(-v // tile)
    pad_v = n_tiles * tile
    if pad_v != v:
        pad = jnp.full((pad_v - v, cfg.sample, cfg.step), -2, jnp.int32)
        paths_p = jnp.concatenate([paths, pad], axis=0)
    else:
        paths_p = paths
    paths_p = paths_p.reshape(n_tiles, tile, cfg.sample, cfg.step)

    @jax.jit
    def pair_block(pi: jax.Array, pj: jax.Array) -> jax.Array:
        # pi: [T, S, L], pj: [T, S, L] -> [T, T] mean first-meet weight
        met = jnp.zeros((tile, tile, cfg.sample, cfg.sample), bool)
        acc = jnp.zeros((tile, tile), jnp.float32)
        for t in range(cfg.step):
            a = pi[:, :, t]  # [T, S]
            b = pj[:, :, t]
            eq = (a[:, None, :, None] == b[None, :, None, :]) & (
                a[:, None, :, None] >= 0
            )
            first = eq & ~met
            acc = acc + (cfg.c ** (t + 1)) * first.sum(
                axis=(2, 3), dtype=jnp.float32
            )
            met = met | eq
        return acc / (cfg.sample * cfg.sample)

    sim = np.zeros((pad_v, pad_v), np.float32)
    for bi in range(n_tiles):
        for bj in range(bi, n_tiles):
            blk = np.asarray(pair_block(paths_p[bi], paths_p[bj]))
            sim[bi * tile : (bi + 1) * tile, bj * tile : (bj + 1) * tile] = blk
            if bj != bi:
                sim[bj * tile : (bj + 1) * tile, bi * tile : (bi + 1) * tile] = blk.T
    sim = sim[:v, :v]
    np.fill_diagonal(sim, 0.0)
    return sim


@partial(jax.jit, static_argnames=("v", "c"))
def step1_mass_sim(
    ends: jax.Array,
    sources: jax.Array,
    v: int,
    c: float,
    s_active,
) -> jax.Array:
    """[n_src, V] one-hop endpoint-mass similarity from the FIRST
    ``s_active`` columns of ``ends`` (int32[V, S_total]; -1 = dead).

    sim(r, w) = c / s_active^2 * <cnt_r, cnt_w> with cnt the endpoint
    histogram over the active walks.  ``s_active`` is a TRACED scalar:
    one compiled executable serves every sample-grid point of the
    doubleRandomWalk / TopSim_doubleSample sweeps (each remote compile
    is expensive, and the round-4 sweeps observed the remote compile
    service dying after ~10 heavy compiles).  Scatter-free: subset
    histogram via ``segment_sum_1d`` keys, the contraction as one gather
    per walk slot.
    """
    from graphtpu.kernels.topk import segment_sum_1d

    n_src = sources.shape[0]
    s_total = ends.shape[1]
    active = jnp.arange(s_total, dtype=jnp.int32) < s_active
    ends = jnp.where(active[None, :], ends, -1)
    sub_ends = ends[sources]  # [n_src, S_total]
    keys = jnp.where(
        sub_ends >= 0,
        jnp.arange(n_src, dtype=jnp.int32)[:, None] * v + sub_ends,
        -1,
    ).reshape(-1)
    cnt_sub = segment_sum_1d(
        keys, jnp.ones_like(keys, jnp.float32), n_src * v
    ).reshape(n_src, v)

    def add_s(acc, col):
        term = jnp.where(
            col[:, None] >= 0,
            cnt_sub[:, jnp.maximum(col, 0)].T,
            0.0,
        )  # [V, n_src]
        return acc + term, None

    acc, _ = jax.lax.scan(
        add_s, jnp.zeros((v, n_src), jnp.float32), ends.T
    )
    denom = s_active.astype(jnp.float32) ** 2
    return (c / denom) * acc.T


def doublewalk_simrank_rows(
    g: Graph,
    cfg: DoubleWalkConfig = DoubleWalkConfig(),
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[n_src, V] double-walk similarity rows for a source subset — the
    sweep-protocol form (``Test_u_u_doubleRandomWalk_Sample.java:32-43``
    scores a source sample against gold, active grid step=1).

    At ``step == 1`` the estimator factorises exactly: first-meet is just
    endpoint equality after one hop, so

        sim(v, w) = C / S^2 * sum_i cnt_v[i] * cnt_w[i]

    with cnt_v the endpoint histogram of v's S walks — one [n_src, V] x
    [V, V] matmul over histograms instead of the O(S^2) pair loop
    (identical sums: sum_{s,s'} 1[a_s == b_s'] == <cnt_a, cnt_b>).
    ``step > 1`` falls back to the blocked pair computation with row
    tiles drawn from ``sources``.
    """
    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    if sources is None:
        sources = np.arange(v, dtype=np.int32)
    sources = np.asarray(sources, dtype=np.int32)
    paths = sample_double_walk_paths(g, cfg.sample, cfg.step, key)

    if cfg.step == 1:
        ends = paths[:, :, 0]  # [V, S] endpoint after one hop (-1 dead)
        sim = np.array(
            step1_mass_sim(
                ends, jnp.asarray(sources), v, cfg.c,
                jnp.int32(cfg.sample),
            )
        )
        for r, s in enumerate(sources):
            sim[r, s] = 0.0
        return sim

    # generic step: blocked pair computation, rows from the subset
    n = len(sources)
    tile = min(cfg.source_tile, n)
    nr = -(-n // tile)
    pad_n = nr * tile
    src_pad = np.concatenate(
        [sources, np.zeros(pad_n - n, np.int32)]
    ) if pad_n != n else sources
    ct = min(cfg.source_tile, v)
    nc = -(-v // ct)
    pad_v = nc * ct
    if pad_v != v:
        pad = jnp.full((pad_v - v, cfg.sample, cfg.step), -2, jnp.int32)
        paths_c = jnp.concatenate([paths, pad], axis=0)
    else:
        paths_c = paths
    paths_c = paths_c.reshape(nc, ct, cfg.sample, cfg.step)

    @jax.jit
    def pair_block(pi: jax.Array, pj: jax.Array) -> jax.Array:
        met = jnp.zeros((tile, ct, cfg.sample, cfg.sample), bool)
        acc = jnp.zeros((tile, ct), jnp.float32)
        for t in range(cfg.step):
            a = pi[:, :, t]
            b = pj[:, :, t]
            eq = (a[:, None, :, None] == b[None, :, None, :]) & (
                a[:, None, :, None] >= 0
            )
            first = eq & ~met
            acc = acc + (cfg.c ** (t + 1)) * first.sum(
                axis=(2, 3), dtype=jnp.float32
            )
            met = met | eq
        return acc / (cfg.sample * cfg.sample)

    sim = np.zeros((pad_n, pad_v), np.float32)
    for bi in range(nr):
        rows = jnp.asarray(src_pad[bi * tile : (bi + 1) * tile])
        pi = paths[jnp.asarray(rows)]
        for bj in range(nc):
            sim[
                bi * tile : (bi + 1) * tile, bj * ct : (bj + 1) * ct
            ] = np.asarray(pair_block(pi, paths_c[bj]))
    sim = sim[:n, :v]
    for r, s in enumerate(sources):
        sim[r, s] = 0.0
    return sim
