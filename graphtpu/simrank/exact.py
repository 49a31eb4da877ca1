"""Exact iterative SimRank — two matmuls per iteration.

The reference computes sim'(i,j) = C/(d_i d_j) * sum_{u in N(i), v in N(j)}
sim(u,v) with a quadruple loop over dense double[V][V] state
(``simrank/SimRank.java:36-77``, STEP=3 iterations, C=0.6, diag pinned to 1
during iteration and zeroed afterwards ``:62-65``; gold standard = 30
iterations per ``benchmark/Test_u_u_TopSim_singleSample.java:17-18``).

In operator form with P = row-stochastic adjacency (P[i,u] = w(i,u) /
sum_u w(i,u)) the update is S' = C * P S P^T — two dense matmuls that map
straight onto the tensor cores.  Rows of P for degree-0 nodes are zero,
reproducing the reference's "deg==0 -> sim 0" rule (``SimRank.java:69``);
row orientation makes asymmetric weighted graphs follow the reference's
per-node weight semantics.

The weighted variant (``simrank/weighted/WeightedSimRank.java:68-93``,
STEP=50) is the same operator with P[i,u] = w(i,u)/sum_u w(i,u).

For multi-host scale, see :func:`graphtpu.dist.sharded_exact_simrank`:
with S row-sharded over a mesh XLA turns P S P^T into local matmuls plus
collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import SimRankConfig, WeightedSimRankConfig
from graphtpu.core.graph import DiGraph, Graph, dense_adjacency, row_normalized
from graphtpu.kernels import spmm as _spmm
from graphtpu.kernels.topk import topk_rows


@partial(jax.jit, static_argnames=("iterations", "matmul_precision"))
def _simrank_iterate(
    w: jax.Array,
    c: float,
    iterations: int,
    matmul_precision: str = "highest",
) -> jax.Array:
    """Iterate S' = C * W S W^T with W row-stochastic."""
    v = w.shape[0]
    eye = jnp.eye(v, dtype=w.dtype)

    def body(_, s):
        s = c * (w @ (s @ w.T))
        # pin the diagonal to 1 between iterations (SimRank.java:27-30:
        # sim[i][i] initialised to 1 and never recomputed)
        return s * (1 - eye) + eye

    with jax.default_matmul_precision(matmul_precision):
        s = jax.lax.fori_loop(0, iterations, body, eye)
    # post-process: sim(i,i) = 0 (SimRank.java:62-65)
    return s * (1 - eye)


def exact_simrank(
    g: Graph,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    dtype=jnp.float32,
    matmul_precision: str = "highest",
) -> jax.Array:
    """Dense [V, V] SimRank scores (diag zeroed).  For V up to ~30k on one
    chip (S is V^2 floats x2 buffers); larger graphs use the sharded path
    in graphtpu.dist or the MC estimators.

    A :class:`DiGraph` gets the standard *directed* SimRank: sim'(i,j) =
    C/(|I(i)||I(j)|) * sum over in-neighbour pairs — the semantics the
    reference's DGraph in-neighbour machinery implies
    (``structures/DGraph.java:91-108``: separate ``ins`` lists with
    ``randInNeighbor``).  That is the same operator with P built from the
    in-CSR."""
    if isinstance(g, DiGraph):
        g = g.in_  # in-neighbour rows: P[i, u] = w(u->i) / sum_in(i)
    a = dense_adjacency(g, dtype=jnp.float32)
    if not weighted and g.weight is not None:
        a = (a > 0).astype(jnp.float32)
    w = row_normalized(a).astype(dtype)
    return _simrank_iterate(w, cfg.c, cfg.iterations, matmul_precision)


@partial(jax.jit, static_argnames=("dtype",))
def _spmm_init(diag_idx: jax.Array, dtype) -> jax.Array:
    # the identity built from a traced operand: a jit whose output depends
    # only on constants may fold a V²-element iota on the host
    v = diag_idx.shape[0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (v, v), 1)
    return (cols == diag_idx[:, None]).astype(dtype)


def spmm_backend() -> str:
    """Where the SimRank products run: ``"gpu"`` takes the Triton CSR
    kernel, any other backend the XLA gather tree."""
    return jax.default_backend()


def build_spmm_plan(g: Graph, weighted: bool = False, width: int = 8):
    """The P·X plan for :func:`spmm_product` on :func:`spmm_backend`."""
    if spmm_backend() == "gpu":
        return _spmm.build_csr_plan(g, weighted=weighted)
    return _spmm.build_reduction_tree(g, width=width, weighted=weighted)


def spmm_product(plan, x: jax.Array, col_block: int = 4096) -> jax.Array:
    """P @ x by the plan's kind (``col_block`` sizes the tree's blocks)."""
    if isinstance(plan, _spmm.CsrPlan):
        return _spmm.csr_spmm(plan, x)
    return _spmm.tree_spmm(plan, x, col_block=col_block)


@partial(jax.jit, static_argnames=("col_block",), donate_argnums=(1,))
def _spmm_apply(plan, s, col_block: int):
    return spmm_product(plan, s, col_block)


@partial(jax.jit, donate_argnums=(0,))
def _transpose(x):
    return x.T


@partial(
    jax.jit, static_argnames=("c", "col_block", "dtype"), donate_argnums=(1,)
)
def _spmm_apply_pin(plan, t, diag_idx, c: float, col_block: int, dtype):
    v = t.shape[0]
    out = c * spmm_product(plan, t, col_block)
    # pin the diagonal to 1 between iterations (SimRank.java:27-30)
    cols = jax.lax.broadcasted_iota(jnp.int32, (v, v), 1)
    return jnp.where(cols == diag_idx[:, None], 1.0, out).astype(dtype)


def _spmm_iterate(plan, s, diag_idx, c: float, col_block: int, dtype):
    """One iteration S' = C·P·S·Pᵀ with the diagonal pinned to 1.

    S is symmetric, so P·S·Pᵀ = P·(P·S)ᵀ.  The transpose is a jit of its
    own, so it is written out row-major: fused into the second product,
    XLA:GPU reads it column-wise inside the tree's row gathers, which made
    an iteration 7.7× slower at blog's size (H100, measured)."""
    ps = _spmm_apply(plan, s, col_block)
    return _spmm_apply_pin(plan, _transpose(ps), diag_idx, c, col_block,
                           dtype)


@partial(jax.jit, donate_argnums=(0,))
def _zero_diag(s: jax.Array, diag_idx: jax.Array) -> jax.Array:
    v = s.shape[0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (v, v), 1)
    return jnp.where(cols == diag_idx[:, None], 0.0, s).astype(s.dtype)


def exact_simrank_spmm(
    g: Graph,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    dtype=jnp.float32,
    width: int = 8,
    col_block: int = 4096,
) -> jax.Array:
    """Exact SimRank with SPARSE P·S / (P·Sᵀ) products (diag zeroed).

    Same fixed point as :func:`exact_simrank` — S' = C·P·S·Pᵀ, diag pinned
    during iteration (``simrank/SimRank.java:36-77``) — but each product
    runs as a sparse-dense product (:mod:`graphtpu.kernels.spmm`) costing
    ~E·V reads instead of V³ FLOPs, with f32 sums (no cumsum
    cancellation): the Triton row-split CSR kernel on a GPU, the XLA
    gather tree elsewhere (:func:`build_spmm_plan`).  The win grows with
    sparsity: dense is compute-bound at V³/peak-FLOPs, this is
    bandwidth-bound at E·V/memory-bandwidth.

    S is O(V²) dense state either way (SimRank's output is all-pairs);
    a :class:`DiGraph` uses in-neighbour rows as in :func:`exact_simrank`.
    S is symmetric, so ``P·(P·S)ᵀ == (P·S·Pᵀ)ᵀ == P·S·Pᵀ`` — each
    iteration spends one transpose, not two.  ``dtype`` is the stored
    iterate's type; bf16 halves its memory (accumulation stays f32 in
    the sharded paths that share this contract).
    """
    if isinstance(g, DiGraph):
        g = g.in_
    plan = build_spmm_plan(g, weighted=weighted, width=width)
    diag_idx = jnp.arange(g.n_nodes, dtype=jnp.int32)
    s = _spmm_init(diag_idx, dtype)
    for _ in range(cfg.iterations):
        s = _spmm_iterate(plan, s, diag_idx, float(cfg.c), col_block, dtype)
    # post-process: sim(i,i) = 0 (SimRank.java:62-65)
    return _zero_diag(s, diag_idx)


def weighted_simrank(
    g: Graph,
    cfg: WeightedSimRankConfig = WeightedSimRankConfig(),
    **kw,
) -> jax.Array:
    return exact_simrank(
        g, SimRankConfig(c=cfg.c, iterations=cfg.iterations, topk=cfg.topk),
        weighted=True, **kw,
    )


def simrank_topk(
    sim: jax.Array, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row descending top-k (values, indices) — the Print.printByOrder
    extraction (diag already zeroed)."""
    vals, idx = topk_rows(sim, k)
    return np.asarray(vals), np.asarray(idx)


def weighted_simrank_reference_oracle(
    g: Graph, c: float, iterations: int
) -> np.ndarray:
    """Literal numpy port of WeightedSimRank.java:68-93:
    sim'(i,j) = C * sum_{u,v} w(i,u) w(j,v) sim(u,v) / (sum w(i,.) sum w(j,.))
    """
    vcount = g.n_nodes
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col)
    w = (
        np.ones_like(col, np.float64)
        if g.weight is None
        else np.asarray(g.weight, np.float64)
    )
    sim = np.eye(vcount)
    wsum = np.array([w[rp[i] : rp[i + 1]].sum() for i in range(vcount)])
    for _ in range(iterations):
        new = np.eye(vcount)
        for i in range(vcount):
            for j in range(i + 1, vcount):
                if wsum[i] == 0 or wsum[j] == 0:
                    new[i, j] = new[j, i] = 0.0
                    continue
                ni, wi = col[rp[i] : rp[i + 1]], w[rp[i] : rp[i + 1]]
                nj, wj = col[rp[j] : rp[j + 1]], w[rp[j] : rp[j + 1]]
                val = c * (wi[:, None] * wj[None, :] * sim[np.ix_(ni, nj)]).sum()
                new[i, j] = new[j, i] = val / (wsum[i] * wsum[j])
        sim = new
    np.fill_diagonal(sim, 0.0)
    return sim


def directed_simrank_reference_oracle(
    g: DiGraph, c: float, iterations: int
) -> np.ndarray:
    """Directed SimRank oracle (float64 quadruple loop over in-neighbours):
    sim'(i,j) = C/(|I(i)||I(j)|) * sum_{u in I(i), v in I(j)} sim(u,v),
    the semantics implied by DGraph's ``ins`` lists
    (``structures/DGraph.java:91-108``)."""
    gin = g.in_
    vcount = gin.n_nodes
    rp, col = np.asarray(gin.row_ptr), np.asarray(gin.col)
    deg = np.asarray(gin.deg)
    sim = np.eye(vcount)
    for _ in range(iterations):
        new = np.eye(vcount)
        for i in range(vcount):
            for j in range(i + 1, vcount):
                if deg[i] == 0 or deg[j] == 0:
                    new[i, j] = new[j, i] = 0.0
                    continue
                ni = col[rp[i] : rp[i + 1]]
                nj = col[rp[j] : rp[j + 1]]
                val = c * sim[np.ix_(ni, nj)].sum() / (deg[i] * deg[j])
                new[i, j] = new[j, i] = val
        sim = new
    np.fill_diagonal(sim, 0.0)
    return sim


def exact_simrank_reference_oracle(
    g: Graph, c: float, iterations: int
) -> np.ndarray:
    """Literal numpy port of the SimRank.java quadruple loop — the parity
    oracle for tests (float64, O(V^2 d^2), tiny graphs only)."""
    vcount = g.n_nodes
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col)
    deg = np.asarray(g.deg)
    sim = np.eye(vcount)
    for _ in range(iterations):
        new = np.eye(vcount)
        for i in range(vcount):
            for j in range(i + 1, vcount):
                if deg[i] == 0 or deg[j] == 0:
                    new[i, j] = new[j, i] = 0.0
                    continue
                ni = col[rp[i] : rp[i + 1]]
                nj = col[rp[j] : rp[j + 1]]
                val = c * sim[np.ix_(ni, nj)].sum() / (deg[i] * deg[j])
                new[i, j] = new[j, i] = val
        sim = new
    np.fill_diagonal(sim, 0.0)
    return sim
