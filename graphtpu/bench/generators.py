"""Synthetic graph generators — the reference's fixture layer.

Ports the semantics of:
  * ``utils/GraphGenerator.java:28-93`` — uniform random (V, avg degree),
    bipartite, and directed variants
  * ``utils/graphTools/RMATGraphGenerator.java:22-50`` — R-MAT power-law
    with (pA, pB, pC, pD) quadrant recursion and a bipartite offset option
  * ``utils/GraphGeneratorBf.java:21-39`` — the 700M-vertex bipartite
    generator with BloomFilter dedup; here dedup is exact via sorted
    uint64 keys, streamed in chunks so memory stays bounded

All generators are numpy-vectorised host code (graph construction is IO,
not device compute) and deterministic given a seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def uniform_random_graph(
    n_nodes: int, avg_degree: int, seed: int = 0, dedup: bool = True
) -> np.ndarray:
    """~n*avg_degree/2 undirected edges with uniform endpoints
    (GraphGenerator.generate semantics: random pairs, self-loops skipped)."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree // 2
    edges = rng.integers(0, n_nodes, size=(int(m * 1.2), 2), dtype=np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]][:m]
    if dedup:
        key = np.minimum(edges[:, 0], edges[:, 1]) * n_nodes + np.maximum(
            edges[:, 0], edges[:, 1]
        )
        _, idx = np.unique(key, return_index=True)
        edges = edges[np.sort(idx)]
    return edges


def bipartite_random_graph(
    n_left: int, n_right: int, avg_degree: int, seed: int = 0
) -> np.ndarray:
    """Left ids [0, n_left), right ids [n_left, n_left+n_right)
    (GraphGenerator.generateBipartite offset convention)."""
    rng = np.random.default_rng(seed)
    m = (n_left + n_right) * avg_degree // 2
    src = rng.integers(0, n_left, size=m, dtype=np.int64)
    dst = rng.integers(0, n_right, size=m, dtype=np.int64) + n_left
    return np.stack([src, dst], axis=1)


def directed_random_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree
    edges = rng.integers(0, n_nodes, size=(int(m * 1.1), 2), dtype=np.int64)
    return edges[edges[:, 0] != edges[:, 1]][:m]


def rmat_graph(
    scale: int,
    n_edges: int,
    p: Tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05),
    seed: int = 0,
    bipartite_offset: bool = False,
) -> np.ndarray:
    """R-MAT recursive-quadrant generator, vectorised.

    ``scale`` -> 2^scale vertices; probabilities (pA, pB, pC, pD) pick the
    (row, col) quadrant at each of ``scale`` levels, exactly the recursion
    of RMATGraphGenerator.java.  ``bipartite_offset`` shifts destination
    ids by 2^scale (its bipartite option).
    """
    rng = np.random.default_rng(seed)
    pa, pb, pc, pd = p
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for level in range(scale):
        u = rng.random(n_edges)
        # quadrant draw: A=(0,0), B=(0,1), C=(1,0), D=(1,1)
        row_bit = (u >= pa + pb).astype(np.int64)
        u2 = np.where(u < pa + pb, u / (pa + pb), (u - pa - pb) / (pc + pd))
        col_threshold = np.where(u < pa + pb, pa / (pa + pb), pc / (pc + pd))
        col_bit = (u2 >= col_threshold).astype(np.int64)
        src = (src << 1) | row_bit
        dst = (dst << 1) | col_bit
    if bipartite_offset:
        dst = dst + (1 << scale)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)


GRAPH500_RMAT = (0.57, 0.19, 0.19, 0.05)


def rmat_unique_edges(
    n_nodes: int,
    n_edges: int,
    seed: int = 0,
    p: Tuple[float, float, float, float] = GRAPH500_RMAT,
    max_rounds: int = 64,
) -> np.ndarray:
    """Exactly ``n_edges`` distinct undirected R-MAT edges over ids
    ``[0, n_nodes)`` — the Graph500 Kronecker recipe at any V.

    Edges are drawn at scale ``ceil(log2 n_nodes)``; vertex labels are
    permuted by the seed (Graph500 shuffles them too, so degree is not
    tied to id order); edges with an endpoint ``>= n_nodes``, self-loops
    and repeats of an undirected pair are dropped; rounds of draws
    continue until ``n_edges`` remain, kept in draw order.
    """
    scale = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(1 << scale)
    keep_frac = (n_nodes / float(1 << scale)) ** 2
    keys = np.zeros(0, np.int64)
    edges = np.zeros((0, 2), np.int64)
    for _ in range(max_rounds):
        need = n_edges - len(keys)
        if need <= 0:
            break
        draw = int(need * 1.5 / keep_frac) + 1024
        e = perm[rmat_graph(scale, draw, p=p, seed=int(rng.integers(2**62)))]
        e = e[(e < n_nodes).all(axis=1)]
        k = np.minimum(e[:, 0], e[:, 1]) * n_nodes + np.maximum(e[:, 0], e[:, 1])
        all_k = np.concatenate([keys, k])
        all_e = np.concatenate([edges, e])
        _, first = np.unique(all_k, return_index=True)
        first = np.sort(first)
        keys, edges = all_k[first], all_e[first]
    if len(keys) < n_edges:
        raise ValueError(
            f"only {len(keys)} distinct R-MAT edges after {max_rounds} "
            f"rounds; {n_edges} asked over {n_nodes} nodes"
        )
    return edges[:n_edges]


def massive_bipartite_graph(
    n_left: int,
    n_right: int,
    avg_degree: int,
    out_path: str,
    seed: int = 0,
    chunk: int = 2_000_000,
    use_native: bool = True,
) -> int:
    """Streamed deduped bipartite edge-list writer for huge V
    (GraphGeneratorBf.java's role).  Prefers the multithreaded C++
    generator with Bloom-filter dedup (native/generate.cpp — the direct
    GraphGeneratorBf equivalent); falls back to exact numpy dedup via
    uint64 set union across a rolling sorted array.  Returns edges
    written."""
    if use_native:
        from graphtpu.native import native_generate_graph

        n = native_generate_graph(
            out_path, "bipartite", n_left, n_right,
            (n_left + n_right) * avg_degree // 2, seed=seed,
        )
        if n is not None:
            return n
    rng = np.random.default_rng(seed)
    target = (n_left + n_right) * avg_degree // 2
    seen = np.empty(0, dtype=np.uint64)
    written = 0
    with open(out_path, "w") as f:
        while written < target:
            m = min(chunk, target - written + chunk // 4)
            src = rng.integers(0, n_left, size=m, dtype=np.uint64)
            dst = rng.integers(0, n_right, size=m, dtype=np.uint64)
            key = src * np.uint64(n_right) + dst
            key_u = np.unique(key)
            fresh = key_u[~np.isin(key_u, seen, assume_unique=True)]
            fresh = fresh[: target - written]
            seen = np.union1d(seen, fresh)
            s = (fresh // np.uint64(n_right)).astype(np.int64)
            d = (fresh % np.uint64(n_right)).astype(np.int64) + n_left
            for a, b in zip(s, d):
                f.write(f"{a} {b}\n")
            written += len(fresh)
    return written
