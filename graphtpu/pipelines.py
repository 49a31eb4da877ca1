"""End-to-end pipelines — the reference CLI entry points, as functions.

``node2vec_pipeline`` is ``node2vec/src/main.py:104-114`` (read graph ->
preprocess -> simulate walks -> learn embeddings -> save .emb), on the device:
walks and SGNS run jitted on device; only file IO is host-side.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np

from graphtpu.core.config import SGNSConfig, WalkConfig
from graphtpu.core.graph import Graph, read_edgelist_graph
from graphtpu.io.embfile import write_emb
from graphtpu.models.sgns import train_sgns
from graphtpu.walks.walker import simulate_walks


def node2vec_pipeline(
    graph: Graph,
    walk_cfg: WalkConfig = WalkConfig(),
    sgns_cfg: SGNSConfig = SGNSConfig(),
    seed: int = 0,
    output: Optional[str] = None,
    labels: Optional[Sequence] = None,
) -> np.ndarray:
    """Returns float32[V, dim] embeddings (rows for isolated nodes ~ init).

    ``labels``: node names for the .emb file; defaults to str(node id).
    The reference writes only nodes seen in walks; we write all non-isolated
    nodes (same set for connected graphs).
    """
    key = jax.random.key(seed)
    k_walk, k_train = jax.random.split(key)
    walks = simulate_walks(
        graph,
        num_walks=walk_cfg.num_walks,
        walk_length=walk_cfg.walk_length,
        key=k_walk,
        p=walk_cfg.p,
        q=walk_cfg.q,
        weighted=graph.is_weighted,
        second_order_mode=walk_cfg.second_order_mode,
        max_trials=walk_cfg.max_rejection_trials,
    )
    syn0, _ = train_sgns(walks, graph.n_nodes, sgns_cfg, key=k_train)
    if output is not None:
        active = np.asarray(graph.deg) > 0
        ids = np.nonzero(active)[0]
        labs = [str(i) for i in ids] if labels is None else [labels[i] for i in ids]
        write_emb(output, syn0[ids], labels=labs)
    return syn0
