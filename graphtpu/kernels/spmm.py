"""CSR × dense SpMM as a padded W-ary gather-reduction tree.

SimRank's operator form S' = C·P·S·Pᵀ (``simrank/SimRank.java:67-77``)
needs the sparse-dense product P·X where P is the row-stochastic
adjacency: row i of P·X is ``(1/d_i) Σ_{u∈N(i)} X[u, :]`` — a segment sum
of gathered rows.  The dense form costs V³ FLOPs; at real-graph density
(E ≪ V²) the SpMM form is bandwidth-bound at ~E·V reads instead.

Two numerical constraints shape the design:

  * a global cumsum + boundary-diff loses precision catastrophically
    (segment value = difference of two O(E)-magnitude prefixes), so the
    1e-6 gold-parity requirement rules it out;
  * variable-length CSR segments are hostile to static shapes.

The plan is a **padded W-ary reduction tree** built host-side once per
graph: every CSR row is chopped into mini-rows of W slots, level 1
gathers W source rows per mini-row and adds them (exact f32 tree sum),
level k≥2 reduces W level-(k-1) partial rows, until each node owns
exactly one row — node order falls out by construction.  Every slot
carries a weight: edge weight (or 1) at level 1, validity at deeper
levels, with pad slots pointing at row 0 with weight 0, and the final
1/Σw row scale folded into the last level's weights — so one primitive,
``gather_rows_sum(slots, weights, table)``, implements every level, and
the deg==0 → zero-row rule (``SimRank.java:69``) costs nothing.  Each
level is plain XLA: the W gathers, weights and sum fuse into one loop.

Weighted P follows ``weighted/WeightedSimRank.java:68-93``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph, host_csr


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "weights"],
    meta_fields=["width", "n_nodes", "real_rows"],
)
@dataclasses.dataclass(frozen=True)
class ReductionTree:
    """Static gather plan for P·X over one graph.

    ``levels[k]``: int32[M_k, W] row indices into the previous level's
    output (level 0 indexes X itself via CSR ``col`` values); pad slots
    point at row 0.  ``weights[k]``: float32[M_k, W] per-slot factors
    (edge weight / Σw at level 0 when the tree is single-level, validity
    or final row scale deeper).  ``levels[-1]`` yields ``n_nodes`` real
    rows in node order (padded to a multiple of ``block``;
    ``real_rows[k]`` is the unpadded M_k).
    """

    levels: Tuple[jax.Array, ...]
    weights: Tuple[jax.Array, ...]
    width: int
    n_nodes: int
    real_rows: Tuple[int, ...]


def _pad_rows(a: np.ndarray, mult: int, fill) -> np.ndarray:
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad, a.shape[1]), fill, a.dtype)])


def build_reduction_tree(
    g: Graph,
    width: int = 8,
    weighted: bool = False,
    block: int = 1,
    row_scale: Optional[np.ndarray] = None,
) -> ReductionTree:
    """Host-side plan construction from CSR (numpy; one pass per level).

    ``row_scale``: override the 1/Σw row normalization — needed when
    ``g`` is a COLUMN-RESTRICTED block of a larger graph (2-D SUMMA
    plans) whose local row sums are partial; the caller passes the
    global 1/Σw of each row instead.
    """
    rp_h, col_h, w_h, _ = host_csr(g)
    rp = np.asarray(rp_h).astype(np.int64)
    col = np.asarray(col_h).astype(np.int64)
    v = g.n_nodes
    d = np.diff(rp)
    w = width

    wsrc = (
        np.asarray(w_h, np.float32)
        if (weighted and w_h is not None)
        else np.ones(len(col), np.float32)
    )
    if row_scale is not None:
        scale = np.asarray(row_scale, np.float32)
        assert scale.shape == (v,), (scale.shape, v)
    else:
        denom = np.zeros(v, np.float64)
        np.add.at(denom, np.repeat(np.arange(v), d), wsrc)
        scale = np.where(
            denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0
        ).astype(np.float32)

    # level 1: mini-rows over the CSR column array; pad -> row 0, weight 0
    m = np.maximum(1, -(-d // w))
    m1 = int(m.sum())
    row_of = np.repeat(np.arange(v), m)
    start = np.cumsum(m) - m
    r_local = np.arange(m1) - start[row_of]
    slots = np.zeros((m1, w), np.int64)
    wts = np.zeros((m1, w), np.float32)
    for j in range(w):
        e = rp[:-1][row_of] + r_local * w + j
        ok = e < rp[1:][row_of]
        slots[ok, j] = col[e[ok]]
        wts[ok, j] = wsrc[e[ok]]
    levels = [slots]
    weights = [wts]
    counts = [m]

    # levels 2+: reduce mini-row counts by W until one row per node
    cnt = m
    while cnt.max() > 1:
        prev_start = np.cumsum(cnt) - cnt
        m2 = np.maximum(1, -(-cnt // w))
        mk = int(m2.sum())
        row_of2 = np.repeat(np.arange(v), m2)
        start2 = np.cumsum(m2) - m2
        r2 = np.arange(mk) - start2[row_of2]
        sl = np.zeros((mk, w), np.int64)
        wt = np.zeros((mk, w), np.float32)
        for j in range(w):
            p = r2 * w + j
            ok = p < cnt[row_of2]
            sl[ok, j] = prev_start[row_of2][ok] + p[ok]
            wt[ok, j] = 1.0
        levels.append(sl)
        weights.append(wt)
        counts.append(m2)
        cnt = m2
    assert levels[-1].shape[0] == v

    # fold the 1/deg (or 1/Σw) row scale into the last level's weights
    weights[-1] = weights[-1] * scale[:, None]

    # pad each level's row count to a block multiple (the sharded plans
    # stack per-device trees); deeper levels index the PREVIOUS level's
    # padded layout, which matches because slot indices are into the
    # unpadded prefix
    real = tuple(l.shape[0] for l in levels)
    levels = [_pad_rows(l, block, 0) for l in levels]
    weights = [_pad_rows(x, block, 0.0) for x in weights]

    return ReductionTree(
        levels=tuple(jnp.asarray(l.astype(np.int32)) for l in levels),
        weights=tuple(jnp.asarray(x) for x in weights),
        width=w,
        n_nodes=v,
        real_rows=real,
    )


# ---------------------------------------------------------------------------
# level primitive: out[m, :] = sum_j weights[m, j] * table[slots[m, j], :]
# ---------------------------------------------------------------------------


def gather_rows_sum(
    slots: jax.Array, weights: jax.Array, table: jax.Array
) -> jax.Array:
    """One tree level: [M, W] slots and weights over table [N, C] -> [M, C]."""
    w = slots.shape[1]
    acc = None
    for j in range(w):
        r = table[slots[:, j]] * weights[:, j][:, None]
        acc = r if acc is None else acc + r
    return acc


def tree_spmm(
    tree: ReductionTree,
    x: jax.Array,
    col_block: int = 4096,
) -> jax.Array:
    """P @ x via the reduction tree.

    Column-blocked so per-level partials ([M1, C_blk]) stay bounded at
    any V; the blocks are balanced, so at most ``n_blocks - 1`` zero
    columns pad the last one.  Jit the CALLER; blocks unroll at trace
    time."""
    v, c = x.shape
    n_blocks = -(-c // min(col_block, c))
    col_block = -(-c // n_blocks)

    def one_block(xb):
        cur = xb
        for lv, wt in zip(tree.levels, tree.weights):
            cur = gather_rows_sum(lv, wt, cur)
        return cur[: tree.n_nodes]

    if c == col_block:
        return one_block(x)
    pad = (-c) % col_block
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))
    blocks = [
        one_block(jax.lax.dynamic_slice_in_dim(x, lo, col_block, 1))
        for lo in range(0, c + pad, col_block)
    ]
    return jnp.concatenate(blocks, axis=1)[:, :c]


# ---------------------------------------------------------------------------
# row-split CSR SpMM for Hopper: Pallas through Triton
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row_ptr", "col", "vals"],
    meta_fields=["n_nodes", "nbr_block"],
)
@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """P as CSR with the row scale folded in: ``vals[k]`` is
    w(i, col[k]) / Σw(i, ·).  ``col``/``vals`` carry ``nbr_block`` zero
    slots past the end so every neighbour-block window stays in range."""

    row_ptr: jax.Array  # int32[V + 1]
    col: jax.Array      # int32[E + nbr_block]
    vals: jax.Array     # float32[E + nbr_block]
    n_nodes: int
    nbr_block: int


def build_csr_plan(
    g: Graph, weighted: bool = False, nbr_block: int = 16
) -> CsrPlan:
    rp_h, col_h, w_h, _ = host_csr(g)
    rp = np.asarray(rp_h).astype(np.int64)
    col = np.asarray(col_h).astype(np.int32)
    v = g.n_nodes
    wsrc = (
        np.asarray(w_h, np.float64)
        if (weighted and w_h is not None)
        else np.ones(len(col), np.float64)
    )
    row = np.repeat(np.arange(v), np.diff(rp))
    denom = np.zeros(v, np.float64)
    np.add.at(denom, row, wsrc)
    vals = (wsrc / np.maximum(denom, 1e-300)[row]).astype(np.float32)
    pad = np.zeros(nbr_block, np.int32)
    return CsrPlan(
        row_ptr=jnp.asarray(rp.astype(np.int32)),
        col=jnp.asarray(np.concatenate([col, pad])),
        vals=jnp.asarray(np.concatenate([vals, pad.astype(np.float32)])),
        n_nodes=v,
        nbr_block=nbr_block,
    )


def _csr_spmm_kernel(nbr_block, col_block, n_cols,
                     rp_ref, col_ref, val_ref, x_ref, y_ref):
    """One program: output row i, columns [j·BN, (j+1)·BN).  It walks row
    i's neighbours ``nbr_block`` at a time, each step one [K, BN] gather
    of table rows, and sums them in f32 registers; Triton pipelines the
    loop's loads over ``num_stages``."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    j = pl.program_id(0)
    i = pl.program_id(1)
    lo = rp_ref[i]
    hi = rp_ref[i + 1]
    cols = j * col_block + jnp.arange(col_block)
    cmask = cols < n_cols

    def body(t, acc):
        k0 = lo + t * nbr_block
        kmask = k0 + jnp.arange(nbr_block) < hi
        idx = plgpu.load(col_ref.at[pl.ds(k0, nbr_block)], mask=kmask,
                         other=0)
        w = plgpu.load(val_ref.at[pl.ds(k0, nbr_block)], mask=kmask,
                       other=0.0)
        rows = plgpu.load(
            x_ref.at[idx[:, None], cols[None, :]],
            mask=kmask[:, None] & cmask[None, :], other=0.0,
        )
        return acc + jnp.sum(rows.astype(jnp.float32) * w[:, None], axis=0)

    n_steps = (hi - lo + nbr_block - 1) // nbr_block
    acc = jax.lax.fori_loop(
        0, n_steps, body, jnp.zeros((col_block,), jnp.float32)
    )
    plgpu.store(y_ref.at[i, pl.ds(j * col_block, col_block)],
                acc.astype(y_ref.dtype), mask=cmask)


def _csr_spmm_call(plan: CsrPlan, x: jax.Array, col_block: int,
                   num_warps: int, num_stages: int, interpret: bool):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    v, c = x.shape
    return pl.pallas_call(
        partial(_csr_spmm_kernel, plan.nbr_block, col_block, c),
        out_shape=jax.ShapeDtypeStruct((plan.n_nodes, c), x.dtype),
        grid=(-(-c // col_block), plan.n_nodes),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="csr_spmm",
    )(plan.row_ptr, plan.col, plan.vals, x)


def csr_spmm(
    plan: CsrPlan,
    x: jax.Array,
    col_block: int = 512,
    num_warps: int = 8,
    num_stages: int = 3,
) -> jax.Array:
    """P @ x on the GPU: [V, C] -> [V, C] in x's dtype, f32 sums.

    Reads each neighbour's row segment once per product: (E + V)·C
    elements moved, no intermediate levels.  ``col_block`` is a power of
    two; column tails are masked."""
    return _csr_spmm_call(plan, x, col_block, num_warps, num_stages, False)


def spmm_oracle(g: Graph, x: np.ndarray, weighted: bool = False) -> np.ndarray:
    """numpy P @ x for tests."""
    rp = np.asarray(g.row_ptr)
    col = np.asarray(g.col)
    v = g.n_nodes
    w = (
        np.asarray(g.weight, np.float64)
        if (weighted and g.weight is not None)
        else np.ones(len(col))
    )
    out = np.zeros((v, x.shape[1]))
    for i in range(v):
        lo, hi = rp[i], rp[i + 1]
        if hi > lo:
            tot = w[lo:hi].sum()
            if tot > 0:
                out[i] = (w[lo:hi, None] * x[col[lo:hi]]).sum(0) / tot
    return out
