#!/usr/bin/env python
"""Measurement body — exact SimRank, walks and SGNS on one GPU.

    python bench.py [--seed N]

Prints ONE JSON line on stdout: {"metric", "value", "unit", "extras"};
everything else goes to stderr.

Workload: the reference's gold-standard computation — exact iterative
SimRank at the size of its largest "single JVM" dataset (blog,
V=10,313, E=333,983; ``conf/MyConfiguration.java:29``,
``simrank/SimRank.java``) on an R-MAT graph (Graph500 parameters)
generated from ``--seed``.  The Java inner loop performs
sum_{i<j} d_i*d_j ~ (2E)^2/2 neighbour-pair updates per iteration; the
headline counts that same algorithmic work in giga-pair-updates/second
for the dense engine.  Extras: the sparse engine's per-iteration time
and effective bytes/s at blog's and arxiv's sizes, first- and
second-order walk rates, and the SGNS step time.

One process; it needs a GPU and exits non-zero without one.  Any
failure ends the run: nothing is skipped or caught.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BLOG_V, BLOG_E = 10_313, 333_983
ARXIV_V, ARXIV_E = 38_741, 334_000  # 668k CSR slots


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rmat(n_nodes: int, n_edges: int, seed: int):
    import graphtpu
    from graphtpu.bench.generators import rmat_unique_edges

    edges = rmat_unique_edges(n_nodes, n_edges, seed=seed)
    return graphtpu.build_graph(edges, n_nodes=n_nodes)


def dense_metrics(g, iters: int = 10):
    """Warm seconds per dense SimRank iteration at "highest" precision
    (the one that meets the 1e-6 gold parity)."""
    from graphtpu.core.graph import dense_adjacency, row_normalized
    from graphtpu.simrank.exact import _simrank_iterate

    w = row_normalized(dense_adjacency(g))
    # warm up the EXACT executable being timed: ``iterations`` is static,
    # so a different count would leave a fresh compile in the timed region
    t0 = time.perf_counter()
    _simrank_iterate(w, 0.6, iters, "highest").block_until_ready()
    log(f"dense warmup(compile): {time.perf_counter() - t0:.1f}s")
    per_iter = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _simrank_iterate(w, 0.6, iters, "highest").block_until_ready()
        per_iter = min(per_iter, (time.perf_counter() - t0) / iters)
    log(f"dense: {per_iter * 1e3:.3f} ms/iter")
    return per_iter


def spmm_metrics(g, name: str, iters: int = 10) -> dict:
    """Warm seconds per ``exact_simrank_spmm`` iteration; effective
    bytes/s counts 2 products/iter, each (slots + V) row reads of V f32."""
    from graphtpu.core.config import SimRankConfig
    from graphtpu.simrank.exact import exact_simrank_spmm

    cfg = SimRankConfig(iterations=iters)
    t0 = time.perf_counter()
    exact_simrank_spmm(g, cfg).block_until_ready()
    log(f"spmm {name} warmup(compile + {iters} iters): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    exact_simrank_spmm(g, cfg).block_until_ready()
    per = (time.perf_counter() - t0) / iters
    rate = 2.0 * (g.n_edges + g.n_nodes) * g.n_nodes * 4 / per
    log(f"spmm {name}: {per * 1e3:.3f} ms/iter, {rate / 1e9:.1f} GB/s effective")
    return {f"spmm_{name}_ms_per_iter": per * 1e3,
            f"spmm_{name}_gbps": rate / 1e9}


def secondary_metrics(g) -> dict:
    """Walks/s (first-order + node2vec 2nd-order) and SGNS step-ms on the
    same graph — the reference's other hot loops
    (``structures/Graph.java:69-73`` randNeighbor walking,
    ``node2vec/src/node2vec.py:150-160``, gensim SGNS step); warm
    executables, compile excluded."""
    import jax
    import jax.numpy as jnp

    from graphtpu.kernels.edgeset import device_edge_set
    from graphtpu.models.sgns import (
        _gather_batch,
        alias_draw_batch,
        build_negative_alias,
        corpus_counts,
        sgns_manual_grads,
    )
    from graphtpu.walks.node2vec import node2vec_walks
    from graphtpu.walks.walker import uniform_walks

    extras = {}
    key = jax.random.key(0)
    nodes = np.flatnonzero(np.asarray(g.deg) > 0).astype(np.int32)

    def timed(fn, *a, reps=3):
        jax.block_until_ready(fn(*a))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*a)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        return out, best

    # first-order walks: B=65536 walkers, 40 hops each
    b1, l1 = 65536, 40
    starts = jnp.asarray(np.random.default_rng(1).choice(nodes, size=b1))
    walk_fn = jax.jit(lambda s, k: uniform_walks(g, s, l1, k))
    _, dt = timed(walk_fn, starts, key)
    extras["walk_uniform_mhops_per_s"] = b1 * l1 / dt / 1e6
    log(f"uniform walks: {extras['walk_uniform_mhops_per_s']:.1f} M hops/s")

    # node2vec 2nd-order (rejection), p=1 q=2: B=32768, 20 hops; the edge
    # set is a jit ARGUMENT (a closure would embed it as a constant)
    b2, l2 = 32768, 20
    starts2 = jnp.asarray(np.random.default_rng(2).choice(nodes, size=b2))
    n2v_fn = jax.jit(
        lambda s, k, e: node2vec_walks(
            g, s, l2, 1.0, 2.0, k, mode="rejection", eset=e
        )
    )
    _, dt = timed(n2v_fn, starts2, key, device_edge_set(g))
    extras["walk_node2vec_mhops_per_s"] = b2 * l2 / dt / 1e6
    log(f"node2vec walks: {extras['walk_node2vec_mhops_per_s']:.1f} M hops/s")

    # SGNS step: B=8192 centers, window=10, 5 shared negatives — the
    # production step body, scanned x20 in one executable
    v = g.n_nodes
    walks = uniform_walks(g, starts[:8192], 40, key)
    neg_j, neg_q = build_negative_alias(corpus_counts(walks, v), 0.75)
    batch, window, neg, nscan = 8192, 10, 5, 20

    @jax.jit
    def sgns_chunk(params, w, kk):
        def step(p, k):
            k_s, k_w, k_n = jax.random.split(k, 3)
            slots = jax.random.randint(
                k_s, (batch,), 0, w.shape[0] * w.shape[1]
            )
            centers, contexts, mask = _gather_batch(w, slots, window, k_w)
            negs = alias_draw_batch(neg_j, neg_q, k_n, (batch, neg))
            (g0, g1), (c0, c1) = sgns_manual_grads(
                p, centers, contexts, mask, negs, v
            )
            s0, s1 = p
            lr = 0.025
            return (
                s0 - lr * g0 / jnp.maximum(c0, 1)[:, None],
                s1 - lr * g1 / jnp.maximum(c1, 1)[:, None],
            ), None

        return jax.lax.scan(step, params, jax.random.split(kk, nscan))[0]

    params = (jnp.zeros((v, 128), jnp.float32),
              jnp.zeros((v, 128), jnp.float32))
    _, dt = timed(sgns_chunk, params, walks, key)
    extras["sgns_step_ms"] = dt / nscan * 1e3
    log(f"sgns: {extras['sgns_step_ms']:.3f} ms/step "
        f"(B={batch}, W={window}, N={neg})")
    return extras


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        log(f"bench: needs a GPU, JAX found {jax.devices()[0].platform}")
        return 2
    from graphtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    g = rmat(BLOG_V, BLOG_E, args.seed)
    log(f"graph: V={g.n_nodes} slots={g.n_edges}")
    per_iter = dense_metrics(g)
    updates_per_s = (2.0 * BLOG_E) ** 2 / 2.0 / per_iter
    extras = {"dense_blog_ms_per_iter": per_iter * 1e3}
    extras.update(secondary_metrics(g))
    extras.update(spmm_metrics(g, "blog"))
    del g
    extras.update(spmm_metrics(rmat(ARXIV_V, ARXIV_E, args.seed + 1), "arxiv"))
    print(json.dumps({
        "metric": "simrank_exact_blog_pair_updates",
        "value": updates_per_s / 1e9,
        "unit": "Gupdates/s",
        "extras": extras,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
