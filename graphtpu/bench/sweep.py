"""Benchmark sweep drivers — the ``benchmark/Test_u_u_*`` analog.

The reference's QA is gold-standard sweeps: per dataset, run an
approximation over a sample grid and score precision@k / NDCG against the
naive-SimRank gold output (``Test_u_u_TopSim_singleSample.java:25-64``,
grid {1000, 2500, 5000, 10000, 20000, 40000} ``:38``).  This module runs
the same protocol over our engines and logs structured results.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import jax
import numpy as np

from graphtpu.core.config import (
    SimRankConfig,
    TopSimConfig,
    UniWalkConfig,
)
from graphtpu.core.graph import Graph
from graphtpu.eval.precision import ndcg_sim_dicts, precision_sim_dicts
from graphtpu.kernels.topk import topk_rows
from graphtpu.simrank.exact import exact_simrank
from graphtpu.simrank.topsim import topsim_simrank
from graphtpu.simrank.uniwalk import uniwalk_simrank
from graphtpu.utils.logging import Log

REFERENCE_SAMPLE_GRID = (1000, 2500, 5000, 10000, 20000, 40000)
# the other swept engines' ACTIVE reference grids:
#   doubleRandomWalk: samples {5,10,50,100,200,400}, step 1
#     (Test_u_u_doubleRandomWalk_Sample.java:32-35)
#   TopSim_doubleSample: samples {5,10,50}, step 1
#     (Test_u_u_TopSim_doubleSample.java:38-40)
#   TopSim_Dev: samples {10000}, step 3 (Test_u_u_TopSim_Dev.java:38-40)
DOUBLEWALK_SAMPLE_GRID = (5, 10, 50, 100, 200, 400)
DOUBLESAMPLE_GRID = (5, 10, 50)
DEV_SAMPLE_GRID = (10000,)


def sim_matrix_to_dict(
    sim: np.ndarray, k: int, sources: Optional[np.ndarray] = None
) -> Dict:
    rows = range(sim.shape[0]) if sources is None else sources
    out = {}
    for r, v in enumerate(rows):
        row = sim[v] if sources is None else sim[r]
        if k < row.shape[0]:
            # argpartition first: full argsort per row over [n_src, V]
            # dominates gold wall time at arxiv scale
            cand = np.argpartition(-row, k)[:k]
            idx = cand[np.argsort(-row[cand])]
        else:
            idx = np.argsort(-row)[:k]
        out[int(v)] = [(int(i), float(row[i])) for i in idx if row[i] > 0]
    return out


def topk_to_dict(
    vals: np.ndarray, idx: np.ndarray, sources: Optional[np.ndarray] = None
) -> Dict:
    keys = range(vals.shape[0]) if sources is None else sources
    out = {}
    for r, v in enumerate(keys):
        out[int(v)] = [
            (int(i), float(s))
            for i, s in zip(idx[r], vals[r])
            if i >= 0 and s > 0
        ]
    return out


def gold_standard(
    g: Graph,
    iterations: int = 30,
    k: int = 1000,
    sources: Optional[np.ndarray] = None,
    impl: str = "dense",
) -> Dict:
    """The reference gold standard: naive SimRank, 30 iterations, top-1000
    per row (``Test_u_u_TopSim_singleSample.java:17-18``,
    ``Print.printByOrderAll``).  ``impl="spmm"`` runs the sparse-SpMM
    form (same fixed point, f32 sums) for graphs past the dense V range;
    ``sources`` restricts the emitted rows (estimation subset)."""
    cfg = SimRankConfig(iterations=iterations)
    if impl == "spmm":
        from graphtpu.simrank.exact import exact_simrank_spmm

        sim = exact_simrank_spmm(g, cfg)
    else:
        sim = exact_simrank(g, cfg)
    if sources is not None:
        sim = np.asarray(sim[np.asarray(sources)])
        return sim_matrix_to_dict(sim, k, sources=np.asarray(sources))
    return sim_matrix_to_dict(np.asarray(sim), k)


@dataclasses.dataclass
class SweepResult:
    algorithm: str
    sample: float
    precision: float
    ndcg: float
    seconds: float


def sweep_uniwalk(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = REFERENCE_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 64,
) -> List[SweepResult]:
    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = uniwalk_simrank(
            g,
            UniWalkConfig(sample=s, step=step, topk=topk, source_tile=source_tile),
            key=key,
            sources=sources,
        )
        dt = time.time() - t0
        approx = topk_to_dict(vals, idx, sources=sources)
        r = SweepResult(
            "uniwalk", s,
            precision_sim_dicts(gold, approx, k=topk),
            ndcg_sim_dicts(gold, approx, k=topk),
            dt,
        )
        results.append(r)
        if log:
            log.info(json.dumps(dataclasses.asdict(r)))
    return results


def sweep_topsim(
    g: Graph,
    gold: Dict,
    samples: Sequence[float] = REFERENCE_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 16,
) -> List[SweepResult]:
    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = topsim_simrank(
            g,
            TopSimConfig(
                sample=float(s), step=step, topk=topk, source_tile=source_tile
            ),
            key=key,
            sources=sources,
        )
        dt = time.time() - t0
        approx = topk_to_dict(vals, idx, sources=sources)
        r = SweepResult(
            "topsim_singleSample", s,
            precision_sim_dicts(gold, approx, k=topk),
            ndcg_sim_dicts(gold, approx, k=topk),
            dt,
        )
        results.append(r)
        if log:
            log.info(json.dumps(dataclasses.asdict(r)))
    return results


def sweep_doublewalk(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = DOUBLEWALK_SAMPLE_GRID,
    step: int = 1,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 64,
) -> List[SweepResult]:
    """DoubleRandomWalk sweep — ``Test_u_u_doubleRandomWalk_Sample.java``
    (active grid samples {5,10,50,100,200,400}, step 1).

    At step 1 every grid point shares ONE walk tensor (generated at the
    grid max) and ONE compiled estimator with the active sample count as
    a traced scalar — the per-point jits of the naive form each cost a
    remote compile, and the compile service was observed dying after
    ~10 of them (round 4)."""
    from graphtpu.core.config import DoubleWalkConfig
    from graphtpu.simrank.doublewalk import (
        doublewalk_simrank_rows,
        sample_double_walk_paths,
        step1_mass_sim,
    )

    results = []
    shared_ends = None
    key = key if key is not None else jax.random.key(0)
    if step == 1:
        smax = max(max(samples), max(DOUBLEWALK_SAMPLE_GRID))
        shared_ends = sample_double_walk_paths(g, smax, 1, key)[:, :, 0]
        src_dev = jax.numpy.asarray(
            sources
            if sources is not None
            else np.arange(g.n_nodes, dtype=np.int32)
        )
    for s in samples:
        t0 = time.time()
        if shared_ends is not None:
            sim = np.array(
                step1_mass_sim(
                    shared_ends, src_dev, g.n_nodes,
                    DoubleWalkConfig().c, jax.numpy.int32(s),
                )
            )
            for r_i, sv in enumerate(np.asarray(src_dev)):
                sim[r_i, sv] = 0.0
        else:
            sim = doublewalk_simrank_rows(
                g,
                DoubleWalkConfig(
                    sample=s, step=step, source_tile=source_tile
                ),
                key=key,
                sources=sources,
            )
        dt = time.time() - t0
        approx = sim_matrix_to_dict(sim, topk, sources=sources)
        r = SweepResult(
            "doubleRandomWalk", s,
            precision_sim_dicts(gold, approx, k=topk),
            ndcg_sim_dicts(gold, approx, k=topk),
            dt,
        )
        results.append(r)
        if log:
            log.info(json.dumps(dataclasses.asdict(r)))
    return results


def sweep_doublesample(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = DOUBLESAMPLE_GRID,
    step: int = 1,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
) -> List[SweepResult]:
    """TopSim_doubleSample sweep — ``Test_u_u_TopSim_doubleSample.java``
    (active grid samples {5,10,50}, step 1), sampled endpoint masses.

    At step 1 the grid shares one walk tensor + one compiled estimator
    (see ``sweep_doublewalk``); the estimators coincide there — both
    score the sampled one-hop endpoint-mass product, which is exactly
    why the reference's two engines converge to the same limit."""
    from graphtpu.core.config import TopSimConfig
    from graphtpu.simrank.meeting import doublesample_similarity_mc
    from graphtpu.simrank.doublewalk import step1_mass_sim
    from graphtpu.walks.walker import uniform_walks

    results = []
    shared_ends = None
    if step == 1:
        smax = max(max(samples), max(DOUBLESAMPLE_GRID))
        starts = jax.numpy.repeat(
            jax.numpy.arange(g.n_nodes, dtype=jax.numpy.int32), smax
        )
        walks = uniform_walks(
            g, starts, 1, key if key is not None else jax.random.key(0)
        )
        shared_ends = walks[:, 1].reshape(g.n_nodes, smax)
        src_dev = jax.numpy.asarray(
            sources
            if sources is not None
            else np.arange(g.n_nodes, dtype=np.int32)
        )
    for s in samples:
        t0 = time.time()
        if shared_ends is not None:
            sim = np.array(
                step1_mass_sim(
                    shared_ends, src_dev, g.n_nodes,
                    TopSimConfig().c, jax.numpy.int32(s),
                )
            )
            for r_i, sv in enumerate(np.asarray(src_dev)):
                sim[r_i, sv] = 0.0
        else:
            sim = doublesample_similarity_mc(
                g, s, TopSimConfig(step=step), key=key, sources=sources
            )
        dt = time.time() - t0
        approx = sim_matrix_to_dict(sim, topk, sources=sources)
        r = SweepResult(
            "topsim_doubleSample", s,
            precision_sim_dicts(gold, approx, k=topk),
            ndcg_sim_dicts(gold, approx, k=topk),
            dt,
        )
        results.append(r)
        if log:
            log.info(json.dumps(dataclasses.asdict(r)))
    return results


def sweep_topsim_dev(
    g: Graph,
    gold: Dict,
    samples: Sequence[float] = DEV_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 16,
) -> List[SweepResult]:
    """TopSim_Dev two-phase sweep — ``Test_u_u_TopSim_Dev.java`` (active
    grid samples {10000}, step 3)."""
    from graphtpu.core.config import TopSimConfig
    from graphtpu.simrank.meeting import topsim_dev

    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = topsim_dev(
            g,
            TopSimConfig(
                sample=float(s), step=step, topk=topk,
                source_tile=source_tile,
            ),
            key=key,
            sources=sources,
        )
        dt = time.time() - t0
        approx = topk_to_dict(vals, idx, sources=sources)
        r = SweepResult(
            "topsim_dev", s,
            precision_sim_dicts(gold, approx, k=topk),
            ndcg_sim_dicts(gold, approx, k=topk),
            dt,
        )
        results.append(r)
        if log:
            log.info(json.dumps(dataclasses.asdict(r)))
    return results
