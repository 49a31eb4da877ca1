"""Laplacian Eigenmaps — spectral embedding.

Reference (``IsoMap_LE/LE.py:35-51``): build a kNN heat-kernel affinity
W_ij = exp(-||xi-xj||^2 / t) over k=10 neighbours, D = rowsum, solve the
eigen-problem of D^-1 (D - W), keep the eigenvectors whose eigenvalues are
the smallest above 1e-5 (``LE.py:62-77``).  The SimRank-LE visualiser
(``IsoMap_LE/simRank.py:95-123``) does the same with W taken from SimRank
top-k values and a D += 1e-6 guard.

Device form: pairwise distances and the affinity are batched matmuls; the
generalised problem is symmetrised (D^-1 L ~ D^-1/2 L D^-1/2 with
y = D^-1/2 u) so ``jnp.linalg.eigh`` applies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import LEConfig


def knn_heat_affinity(x: jax.Array, k: int, t: float) -> jax.Array:
    """Symmetrised kNN heat-kernel weights (LE.py:35-43 semantics).

    The reference marks W_ij nonzero when j is in i's kNN; we symmetrise
    with max (i.e. an undirected kNN graph), which its dense eig handles
    identically for connected clouds.
    """
    sq = jnp.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = jnp.maximum(d2, 0.0)
    n = x.shape[0]
    d2 = d2.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
    # kNN mask: distance below the k-th smallest per row
    kth = -jax.lax.top_k(-d2, k)[0][:, -1]
    mask = d2 <= kth[:, None]
    w = jnp.where(mask, jnp.exp(-d2 / t), 0.0)
    return jnp.maximum(w, w.T)


def laplacian_eigenmaps(
    w: jax.Array,
    out_dim: int = 2,
    eig_floor: float = 1e-5,
    guard: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve D^-1 (D - W); return (Y [n, out_dim], eigvalues kept).

    ``guard`` adds the simRank.py D += 1e-6 stabiliser for rows with no
    affinity mass.
    """
    d = jnp.sum(w, axis=1) + guard
    d_isqrt = jnp.where(d > 0, 1.0 / jnp.sqrt(jnp.maximum(d, 1e-30)), 0.0)
    lsym = jnp.eye(w.shape[0]) - (d_isqrt[:, None] * w) * d_isqrt[None, :]
    evals, evecs = jnp.linalg.eigh(lsym)          # ascending
    y_full = d_isqrt[:, None] * evecs             # generalised eigvectors
    evals_np = np.asarray(evals)
    keep = np.nonzero(evals_np > eig_floor)[0][:out_dim]
    return np.asarray(y_full[:, keep]), evals_np[keep]


def le_embed_points(
    x: np.ndarray, cfg: LEConfig = LEConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """The LE.py flow: points -> kNN heat kernel -> spectral embedding."""
    w = knn_heat_affinity(jnp.asarray(x, jnp.float32), cfg.k_neighbors, cfg.heat_t)
    return laplacian_eigenmaps(w, cfg.out_dim, cfg.eig_floor)


def le_embed_sim_dict(
    sim_dict, n_nodes: int, cfg: LEConfig = LEConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """The simRank.py flow: top-k SimRank values as affinities
    (``simRank.py:95-123``), D guarded by 1e-6."""
    w = np.zeros((n_nodes, n_nodes), np.float32)
    for src, pairs in sim_dict.items():
        for dst, val in pairs:
            w[src, dst] = val
    w = np.maximum(w, w.T)
    return laplacian_eigenmaps(
        jnp.asarray(w), cfg.out_dim, cfg.eig_floor, guard=1e-6
    )


def make_swiss_roll(
    n: int = 2000, key: Optional[jax.Array] = None, noise: float = 0.0
) -> np.ndarray:
    """Swiss-roll point cloud (LE.py:19-33 make_swiss_roll equivalent)."""
    rng = np.random.default_rng(0 if key is None else int(jax.random.randint(key, (), 0, 2**31 - 1)))
    t = 1.5 * np.pi * (1 + 2 * rng.random(n))
    h = 21.0 * rng.random(n)
    x = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1)
    if noise:
        x += noise * rng.normal(size=x.shape)
    return x.astype(np.float32)
