"""Meeting-probability SimRank estimators — TopSim_doubleSample / TopSim_Dev.

``TopSim_doubleSample`` (``simrank/TopSim_doubleSample.java:20-210``) runs
one budget-splitting walk per source, records the endpoint mass reaching
each node at each step, then scores

    sim(v, w) = sum_t C^t * sum_i mass_v[i, t] * mass_w[i, t]

(``getSim :196-210``).  With the even-split branch dominating (sample >>
degree) the endpoint mass converges to the exact t-step transition
distribution M_t = e_v (D^-1 A)^t — so the device form is pure matmul:

    sim = sum_t C^t * M_t M_t^T,   M_t = M_{t-1} (D^-1 A)

``TopSim_Dev`` (``simrank/TopSim_Dev.java:24-268``) is the two-phase
variant: (1) single-walk spreading scores pick the top ``singleK``
candidates per source, (2) each candidate pair is verified with the
endpoint-mass product score.  Here phase 1 is :func:`topsim_simrank` and
phase 2 re-scores candidates from the same M_t matrices.

Both reference versions leave scores unnormalised (mass carries the
SAMPLE scale; only ranking is consumed).  We normalise masses to
probability scale so scores are comparable across engines; rankings are
unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import TopSimConfig
from graphtpu.core.graph import Graph, column_normalized, dense_adjacency
from graphtpu.kernels.topk import topk_rows


@partial(jax.jit, static_argnames=("step",))
def _meeting_similarity(p_row: jax.Array, c: float, step: int) -> jax.Array:
    """sum_t C^t M_t M_t^T with M_t = M_{t-1} @ P (P row-stochastic)."""
    v = p_row.shape[0]
    m = jnp.eye(v, dtype=p_row.dtype)
    sim = jnp.zeros((v, v), p_row.dtype)
    for t in range(1, step + 1):
        m = m @ p_row
        sim = sim + (c ** t) * (m @ m.T)
    return sim


def doublesample_similarity(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    matmul_precision: str = "high",
) -> np.ndarray:
    """Dense [V, V] meeting-probability similarity (diag zeroed)."""
    a = dense_adjacency(g)
    # row-stochastic transition matrix: row v = uniform over N(v)
    rowsum = a.sum(axis=1, keepdims=True)
    p_row = jnp.where(rowsum > 0, a / jnp.where(rowsum > 0, rowsum, 1.0), 0.0)
    with jax.default_matmul_precision(matmul_precision):
        sim = _meeting_similarity(p_row, cfg.c, cfg.step)
    sim = np.array(sim)  # writable copy off-device
    np.fill_diagonal(sim, 0.0)
    return sim


def doublesample_similarity_mc(
    g: Graph,
    sample: int,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[n_src, V] SAMPLED endpoint-mass similarity — the finite-budget
    regime of ``TopSim_doubleSample`` (``simrank/TopSim_doubleSample
    .java:20-210``; active sweep grid samples {5,10,50}, step 1:
    ``benchmark/Test_u_u_TopSim_doubleSample.java:38-40``).

    Each node runs ``sample`` independent walks; the empirical mass
    m_v[i, t] = #walks of v at node i after t hops / sample replaces the
    even-split spreading mass, and

        sim(v, w) = sum_t C^t * <m_v[:, t], m_w[:, t]>

    (``getSim :196-210``).  As sample grows this converges to the exact
    transition-mass product of :func:`doublesample_similarity` — the
    convergence the sweep table records.  Scatter-free: subset masses via
    ``segment_sum_1d`` keys, the <m_v, m_w> contraction as one gather
    per walk slot (see ``doublewalk_simrank_rows``).
    """
    import jax

    from graphtpu.kernels.topk import segment_sum_1d
    from graphtpu.walks.walker import uniform_walks

    if key is None:
        key = jax.random.key(0)
    v = g.n_nodes
    if sources is None:
        sources = np.arange(v, dtype=np.int32)
    sources = np.asarray(sources, dtype=np.int32)
    n_src = len(sources)
    starts = jnp.repeat(jnp.arange(v, dtype=jnp.int32), sample)
    walks = uniform_walks(g, starts, cfg.step, key)  # [V*S, step+1]
    pos = walks[:, 1:].reshape(v, sample, cfg.step)

    @jax.jit
    def run(pos, src):
        acc = jnp.zeros((v, n_src), jnp.float32)
        for t in range(cfg.step):
            ends = pos[:, :, t]  # [V, S]
            sub_ends = ends[src]
            keys = jnp.where(
                sub_ends >= 0,
                jnp.arange(n_src, dtype=jnp.int32)[:, None] * v + sub_ends,
                -1,
            ).reshape(-1)
            cnt_sub = segment_sum_1d(
                keys, jnp.ones_like(keys, jnp.float32), n_src * v
            ).reshape(n_src, v)

            def add_s(a, col):
                term = jnp.where(
                    col[:, None] >= 0,
                    cnt_sub[:, jnp.maximum(col, 0)].T,
                    0.0,
                )
                return a + term, None

            tacc, _ = jax.lax.scan(
                add_s, jnp.zeros((v, n_src), jnp.float32), ends.T
            )
            acc = acc + (cfg.c ** (t + 1)) * tacc
        return acc.T / (sample * sample)

    sim = np.array(run(pos, jnp.asarray(sources)))
    for r, s in enumerate(sources):
        sim[r, s] = 0.0
    return sim


def topsim_dev(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    single_k: int = 10,
    key: Optional[jax.Array] = None,
    sources: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-phase TopSim_Dev: spreading-walk candidates, meeting-score
    verification.  Returns (values [N, topk], indices [N, topk]) for all
    sources or the given subset (the sweep protocol scores a source
    sample, ``Test_u_u_TopSim_Dev.java:38-40``)."""
    from graphtpu.simrank.topsim import topsim_simrank

    # phase 1: candidates from the single-walk spreading scores
    cand_vals, cand_idx = topsim_simrank(
        g,
        TopSimConfig(
            c=cfg.c, step=cfg.step, sample=cfg.sample,
            topk=max(single_k, cfg.topk), source_tile=cfg.source_tile,
            frontier_capacity=cfg.frontier_capacity,
            normalize=cfg.normalize,
        ),
        key=key,
        sources=sources,
    )
    # phase 2: verify candidates with the endpoint-mass product score
    sim = doublesample_similarity(g, cfg)
    if sources is not None:
        sim = sim[np.asarray(sources)]
    n, k = cand_idx.shape
    rows = np.repeat(np.arange(n), k)
    cols = cand_idx.reshape(-1)
    verified = np.where(
        cols >= 0, sim[rows, np.maximum(cols, 0)], -np.inf
    ).reshape(n, k)
    order = np.argsort(-verified, axis=1)[:, : cfg.topk]
    out_idx = np.take_along_axis(cand_idx, order, axis=1)
    out_val = np.take_along_axis(verified, order, axis=1)
    out_val = np.where(np.isfinite(out_val), out_val, 0.0).astype(np.float32)
    return out_val, out_idx
