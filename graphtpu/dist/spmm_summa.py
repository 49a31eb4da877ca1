"""2-D SUMMA sharded sparse SimRank — S' = C·P·S·Pᵀ on an r×c grid.

The 1-D ring (:mod:`graphtpu.dist.spmm_sharded`) ships each device's
column block around the whole ring: ~V² ring bytes per device per
product, which grows past the per-device compute at the reference's
V=1M/8-device shape by an analytic bytes-per-step count — exactly where
the reference's 14-worker cluster ran
(``giraph/CombineBatchSingleWalkVertexReuse.java:297``).  The 2-D
decomposition cuts per-device collective bytes to ~V²·(1/r + 1/c)
(≈ 2V²/√n on a square grid):

* **Mesh**: (r, c) grid with axes ``("pr", "pc")``.
* **P is 2-D block-partitioned and STATIC**: device (i, j) holds a
  gather-tree plan for the sub-CSR (rows ``r_i``, columns ``kc_j``),
  column ids local to its k-block, normalized by the GLOBAL row sums
  (``build_reduction_tree(row_scale=...)``).  O(E/n) plan memory, zero
  plan communication.
* **S lives in "transposed" block layout**: device (i, j) holds
  ``S[kc_j, cr_i]`` — a [V/c, V/r] block, O(V²/n).
* **One product P·X = r ring steps along "pr"**: at step t device
  (i, j) multiplies its plan against the X block in hand —
  k-block j's partial of ``(P·X)[r_i, cr_m]``, m=(i+t)%r — then
  ``psum_scatter`` along "pc" reduces the c partials and leaves each
  device a 1/c row-strip of the result; the X block ppermutes along
  "pr".  Ring bytes V²/c + reduce bytes V²/r per device per product.
* **The layout transpose is one all_to_all along "pc"** (V²/n bytes):
  row strips regroup into ``Yᵀ`` blocks in the same transposed layout
  the next product consumes; S' is symmetric so the iteration output
  re-enters directly (same trick as the 1-D ring).

Per device: memory O(V²/n + E/n), compute O(E·V/n), communication
V²(1/r + 1/c + 2/n) per product vs the 1-D ring's ~V²(1 - 1/n); bf16
iterates halve every collective payload.  Neither decomposition's
communication has been measured on cards yet.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.config import SimRankConfig
from graphtpu.core.graph import Graph, host_csr, pad_graph_nodes
from graphtpu.kernels.spmm import build_reduction_tree


def make_2d_mesh(r: int, c: int, devices=None) -> Mesh:
    """An (r, c) grid mesh with axes ("pr", "pc")."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= r * c, (devices.size, r, c)
    return Mesh(devices.reshape(-1)[: r * c].reshape(r, c), ("pr", "pc"))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "weights"],
    meta_fields=["n_nodes", "r", "c"],
)
@dataclasses.dataclass(frozen=True)
class SummaPlan:
    """Per-device 2-D block tree plans, stacked on (r, c) leading axes.

    ``levels[k]``: int32[r, c, M_k, W]; level 0 slots index the LOCAL
    rows of the k-block in hand (0..V/c), deeper levels the previous
    level's outputs.  All r·c blocks are padded to common depth and
    per-level row counts so one program serves every device.
    """

    levels: Tuple[jax.Array, ...]
    weights: Tuple[jax.Array, ...]
    n_nodes: int
    r: int
    c: int


def _block_graph(
    rp: np.ndarray,
    col: np.ndarray,
    w: Optional[np.ndarray],
    deg_block: np.ndarray,
    row_lo: int,
    row_hi: int,
    col_lo: int,
    col_hi: int,
) -> Graph:
    """Sub-CSR of rows [row_lo, row_hi) restricted to columns
    [col_lo, col_hi), column ids rebased to the block."""
    e_lo, e_hi = int(rp[row_lo]), int(rp[row_hi])
    cb = col[e_lo:e_hi]
    keep = (cb >= col_lo) & (cb < col_hi)
    # per-row kept counts -> block row_ptr
    row_of = np.repeat(
        np.arange(row_hi - row_lo), np.diff(rp[row_lo : row_hi + 1])
    )
    cnt = np.zeros(row_hi - row_lo, np.int64)
    np.add.at(cnt, row_of[keep], 1)
    rp_b = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    return Graph(
        row_ptr=jnp.asarray(rp_b),
        col=jnp.asarray((cb[keep] - col_lo).astype(np.int32)),
        weight=None if w is None else jnp.asarray(w[e_lo:e_hi][keep]),
        deg=jnp.asarray(cnt.astype(np.int32)),
        max_degree=int(cnt.max()) if len(cnt) else 1,
    )


def build_summa_plan(
    g: Graph,
    r: int,
    c: int,
    width: int = 8,
    weighted: bool = False,
    mesh: Optional[Mesh] = None,
) -> SummaPlan:
    """2-D block tree plans with GLOBAL row normalization, equalised and
    stacked [r, c, ...]; with ``mesh`` each device physically holds only
    its own (i, j) plan block."""
    v = g.n_nodes
    assert v % (r * c) == 0, "pad the graph to a multiple of r*c first"
    rows_per, kc = v // r, v // c
    rp_h, col_h, w_h, _ = host_csr(g)
    rp = np.asarray(rp_h).astype(np.int64)
    col = np.asarray(col_h).astype(np.int64)
    w = (
        np.asarray(w_h, np.float32)
        if (weighted and w_h is not None)
        else None
    )
    # global 1/Σw row scale (column-restricted blocks see partial sums)
    wsrc = w if w is not None else np.ones(len(col), np.float32)
    denom = np.zeros(v, np.float64)
    np.add.at(denom, np.repeat(np.arange(v), np.diff(rp)), wsrc)
    gscale = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0).astype(
        np.float32
    )

    trees = []
    for i in range(r):
        row_lo, row_hi = i * rows_per, (i + 1) * rows_per
        for j in range(c):
            sub = _block_graph(
                rp, col, w, None, row_lo, row_hi, j * kc, (j + 1) * kc
            )
            trees.append(
                build_reduction_tree(
                    sub,
                    width=width,
                    weighted=weighted,
                    block=8,
                    row_scale=gscale[row_lo:row_hi],
                )
            )
    depth = max(len(t.levels) for t in trees)

    def extend(t):
        levels = [np.asarray(l) for l in t.levels]
        weights = [np.asarray(x) for x in t.weights]
        real = list(t.real_rows)
        while len(levels) < depth:
            n_rows = real[-1]
            sl = np.zeros((n_rows, width), np.int32)
            sl[:, 0] = np.arange(n_rows)
            wt = np.zeros((n_rows, width), np.float32)
            wt[:, 0] = 1.0
            levels.append(sl)
            weights.append(wt)
            real.append(n_rows)
        return levels, weights

    ext = [extend(t) for t in trees]
    out_levels, out_weights = [], []
    for k in range(depth):
        mk = max(e[0][k].shape[0] for e in ext)
        ls = np.zeros((r, c, mk, width), np.int32)
        ws = np.zeros((r, c, mk, width), np.float32)
        for d, (lv, wt) in enumerate(ext):
            i, j = divmod(d, c)
            ls[i, j, : lv[k].shape[0]] = lv[k]
            ws[i, j, : wt[k].shape[0]] = wt[k]
        out_levels.append(ls)
        out_weights.append(ws)

    def put(x):
        x = jnp.asarray(x)
        if mesh is None:
            return x
        return jax.device_put(
            x, NamedSharding(mesh, P("pr", "pc", None, None))
        )

    return SummaPlan(
        levels=tuple(put(l) for l in out_levels),
        weights=tuple(put(x) for x in out_weights),
        n_nodes=v,
        r=r,
        c=c,
    )


def _tree_apply(levels, weights, x: jax.Array, rows_per: int) -> jax.Array:
    """[V/c, C] block -> [rows_per, C] float32 (f32 accumulation even
    for bf16 blocks, same as the 1-D ring)."""
    table = x
    for lv, wt in zip(levels, weights):
        lv, wt = lv[0, 0], wt[0, 0]
        acc = None
        for j in range(lv.shape[1]):
            g = table[lv[:, j]].astype(jnp.float32) * wt[:, j][:, None]
            acc = g if acc is None else acc + g
        table = acc
    return table[:rows_per]


def make_summa_iter(
    g: Graph,
    mesh: Mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[SummaPlan] = None,
    dtype=jnp.float32,
):
    """Build the 2-D iteration executables: returns
    ``(plan, v, init, run_n, zero_diag)`` — same contract as
    :func:`graphtpu.dist.spmm_sharded.make_sharded_iter`, S carried in
    the transposed block layout (global arrays sharded ``P("pc","pr")``)."""
    from jax import shard_map

    assert mesh.axis_names == ("pr", "pc"), mesh.axis_names
    r, c = mesh.devices.shape
    v_real = g.n_nodes
    mult = r * c
    v = -(-v_real // mult) * mult
    gp = pad_graph_nodes(g, v) if v != v_real else g
    if plan is None:
        plan = build_summa_plan(
            gp, r, c, width=width, weighted=weighted, mesh=mesh
        )
    rows_per, kc = v // r, v // c
    strip = rows_per // c

    plan_specs = tuple(P("pr", "pc", None, None) for _ in plan.levels)
    blk_spec = P("pc", "pr")   # S[kc_j, cr_i] at device (i, j)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(blk_spec,) + plan_specs + plan_specs,
        out_specs=blk_spec,
    )
    def one_iter(s_blk, *lw):
        levels, weights = lw[: len(plan.levels)], lw[len(plan.levels):]
        mi = jax.lax.axis_index("pr")
        mj = jax.lax.axis_index("pc")

        def ring_product(x_blk):
            """P·X row strips: [strip, v] = (P·X)[strip(mi, mj), :]."""
            y = jax.lax.pcast(
                jnp.zeros((strip, v), jnp.float32), ("pr", "pc"),
                to="varying",
            )

            def step(t, carry):
                y, blk = carry
                m = (mi + t) % r       # column block currently in hand
                w_full = _tree_apply(levels, weights, blk, rows_per)
                # reduce the c k-block partials; each device keeps 1/c
                # of the rows (bytes/step: (V/r)²·(c-1)/c, in the block
                # dtype — bf16 iterates halve it)
                w_strip = jax.lax.psum_scatter(
                    w_full.astype(x_blk.dtype), "pc",
                    scatter_dimension=0, tiled=True,
                ).astype(jnp.float32)
                y = jax.lax.dynamic_update_slice(
                    y, w_strip, (0, m * rows_per)
                )
                blk = jax.lax.ppermute(
                    blk, "pr", [(k, (k - 1) % r) for k in range(r)]
                )
                return y, blk

            y, _ = jax.lax.fori_loop(0, r, step, (y, x_blk))
            return y

        def strip_to_input(y):
            """[strip, v] row strips -> [kc, rows_per] transposed block
            (one all_to_all along "pc", V²/n bytes per device)."""
            recv = jax.lax.all_to_all(
                y.astype(dtype), "pc", split_axis=1, concat_axis=0,
                tiled=True,
            )                                   # [rows_per, kc] = Y[cr_mi, kc_mj]
            return recv.T                       # Yᵀ[kc_mj, cr_mi]

        ps = ring_product(s_blk)                # (P·S) strips
        z = strip_to_input(ps)                  # (P·S)ᵀ blocks
        out = cfg.c * ring_product(z)           # C·P·(P·S)ᵀ strips
        # pin diag: local strip row q is global row
        # mi·rows_per + mj·strip + q (SimRank.java:27-30)
        rows_g = mi * rows_per + mj * strip + jnp.arange(
            strip, dtype=jnp.int32
        )
        cols_g = jax.lax.broadcasted_iota(jnp.int32, (strip, v), 1)
        out = jnp.where(cols_g == rows_g[:, None], 1.0, out)
        # S' symmetric: its transpose-layout blocks ARE the next input
        return strip_to_input(out)

    @partial(shard_map, mesh=mesh, in_specs=(blk_spec,), out_specs=blk_spec)
    def zero_diag(s_blk):
        mi = jax.lax.axis_index("pr")
        mj = jax.lax.axis_index("pc")
        rows_g = mj * kc + jax.lax.broadcasted_iota(
            jnp.int32, (kc, rows_per), 0
        )
        cols_g = mi * rows_per + jax.lax.broadcasted_iota(
            jnp.int32, (kc, rows_per), 1
        )
        return jnp.where(rows_g == cols_g, 0.0, s_blk)

    @partial(
        shard_map, mesh=mesh, in_specs=(P("pr", "pc"),), out_specs=blk_spec
    )
    def init(dummy):
        mi = jax.lax.axis_index("pr")
        mj = jax.lax.axis_index("pc")
        rows_g = mj * kc + jax.lax.broadcasted_iota(
            jnp.int32, (kc, rows_per), 0
        )
        cols_g = mi * rows_per + jax.lax.broadcasted_iota(
            jnp.int32, (kc, rows_per), 1
        )
        return (rows_g == cols_g).astype(dtype) + dummy.astype(dtype)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
    def run_n(s, n_iters, *lw):
        return jax.lax.fori_loop(
            0, n_iters, lambda _, x: one_iter(x, *lw), s
        )

    return plan, v, jax.jit(init), run_n, jax.jit(
        zero_diag, donate_argnums=(0,)
    )


def summa_simrank_spmm(
    g: Graph,
    mesh: Mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[SummaPlan] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """Exact SimRank on the 2-D grid; same fixed point as
    ``exact_simrank_spmm`` (diag pinned during iteration, zeroed after;
    ``SimRank.java:27-30,62-65``).  Returns the [V, V] result (blocks
    stay device-resident under a ``P("pc","pr")`` sharding)."""
    from graphtpu.core.graph import DiGraph

    if isinstance(g, DiGraph):
        # in-neighbour rows, as in exact_simrank (DGraph semantics:
        # sim flows along incoming edges, structures/DGraph.java)
        g = g.in_
    r, c = mesh.devices.shape
    v_real = g.n_nodes
    plan, v, init, run_n, zero_diag = make_summa_iter(
        g, mesh, cfg, weighted=weighted, width=width, plan=plan,
        dtype=dtype,
    )
    s = init(jnp.zeros((r, c), jnp.float32))
    s = run_n(s, cfg.iterations, *(plan.levels + plan.weights))
    s = zero_diag(s)
    return s[:v_real, :v_real]
