"""graphtpu — a JAX graph-embedding framework.

A from-scratch JAX/XLA re-design of the capabilities of the
Junshuai-Song/Graph-Embedding reference repo (node2vec, SDNE, DeepSim,
Laplacian Eigenmaps, exact/Monte-Carlo/TopSim SimRank, distributed
single-walk SimRank, and the associated evaluation harnesses).

Layout (mirrors SURVEY.md §7):
  core/     GraphCSR containers, typed config, PRNG streams, dataset registry
  io/       edge-list / .mat / .sim.txt / .emb readers+writers (reference formats)
  kernels/  XLA kernels: walk step, top-k accumulate, SimRank SpMM
  walks/    uniform & node2vec second-order walkers
  simrank/  exact / weighted / MC single+double walk / TopSim family
  models/   SGNS, SDNE, DeepSim, Laplacian Eigenmaps
  dist/     mesh setup, partitioners, frontier exchange, batched source windows
  eval/     precision@k, NDCG@k, TopKRanker micro/macro-F1, walk statistics
  bench/    dataset registry and sweep drivers
"""

__version__ = "0.1.0"

from graphtpu.core.graph import (
    Graph,
    DiGraph,
    build_graph,
    load_graph_cached,
    read_edgelist_graph,
)

__all__ = [
    "Graph",
    "DiGraph",
    "build_graph",
    "load_graph_cached",
    "read_edgelist_graph",
    "__version__",
]
