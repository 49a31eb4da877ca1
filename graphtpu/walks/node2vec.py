"""Second-order (p, q)-biased node2vec walks, batched on the device.

The reference materialises a Walker alias table per *directed edge*
(``node2vec/src/node2vec.py:83-113``) — O(sum_dst deg(dst)) memory, the
scaling wall called out in SURVEY.md §7.  We never materialise per-edge
tables.  Two batched strategies, statistically equivalent to the
reference bias rule (``node2vec.py:61-81``):

  w'(x) = w(cur,x)/p  if x == prev
        = w(cur,x)    if edge(x, prev)
        = w(cur,x)/q  otherwise

* ``rejection`` (default, scales to any degree): propose x ~ w(cur,·) with
  one CSR gather, accept with prob bias(x)/max(1/p, 1, 1/q).  The edge
  check is a constant-probe EdgeSet lookup (``kernels/edgeset.py``:
  bitmap for small V, cuckoo filter beyond), and cur's row pointer /
  degree are gathered once per hop and shared across the whole proposal
  panel — the walk step is ~2 gathers per proposal instead of round-2's
  ~16 (per-proposal CSR bisection), the second-order throughput
  cliff.  After ``max_trials`` panel
  slots the last proposal stands (acceptance >= min(1/p,1,1/q)/qmax per
  trial, so the residual bias is (1-a)^max_trials; the default panel
  width is sized from (p, q) to push that below 1e-3).
* ``exact`` (small graphs / parity tests): gather the padded neighbour row,
  compute the full biased categorical, Gumbel-max sample.  O(B * Dmax).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.graph import Graph, padded_neighbors
from graphtpu.kernels.edgeset import EdgeSet, edge_set, edge_set_contains
from graphtpu.kernels.sampling import (
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)


def default_max_trials(p: float, q: float, residual: float = 1e-3) -> int:
    """Panel width so the worst-case fallback mass (every neighbour in the
    lowest-bias class, acceptance a = min(1/p,1,1/q)/max(1/p,1,1/q)) is
    below ``residual``: (1-a)^T <= residual."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    a = min(inv_p, 1.0, inv_q) / max(inv_p, 1.0, inv_q)
    if a >= 1.0:
        return 1
    import math

    return int(min(24, max(2, math.ceil(math.log(residual) / math.log(1 - a)))))


def _second_order_step_rejection(
    g: Graph,
    cumw,
    eset: EdgeSet,
    prev: jax.Array,
    cur: jax.Array,
    key: jax.Array,
    inv_p: float,
    inv_q: float,
    max_trials: int,
    weighted: bool,
) -> jax.Array:
    qmax = max(inv_p, 1.0, inv_q)
    # Proposals are drawn as [B, C] panel CHUNKS inside a while_loop that
    # stops as soon as the not-yet-accepted fraction falls below the same
    # residual the fixed panel is sized for (default_max_trials: 1e-3) —
    # so the gather traffic tracks the OBSERVED rejection rate instead of
    # the adversarial all-triangle worst case (the fixed T=24 panel at
    # p=q=0.25 pays 24 gathers/hop when nearly every first trial
    # accepts).  Chunks are iid trials, so "first accepted proposal
    # across chunks" is distributionally identical to the one-shot panel;
    # walkers still unaccepted when the loop exits keep their last
    # proposal — the same fallback, and the loop only exits early when
    # such walkers are < residual of the batch.  cur's degree and row
    # pointer are gathered ONCE per hop and reused by every chunk; the
    # triangle test is a constant-probe EdgeSet lookup.
    b, t = cur.shape[0], max_trials
    # Friendly regimes (T <= 10) run the full panel in ONE round —
    # identical work to the pre-adaptive sampler (any chunking there
    # adds serialised gather rounds whenever >0.1% of walkers reject a
    # whole chunk, which at p=1,q=2 happens every hop: 0.5^8 ≈ 0.4%).  Adversarially wide panels
    # (p=q=0.25 ⇒ T=24) run 8-trial chunks with the early exit, so
    # their typical cost drops to one round instead of always paying T.
    chunk = t if t <= 10 else 8
    n_chunks = -(-t // chunk)
    residual = 1e-3

    if weighted:
        curw = jnp.broadcast_to(cur[:, None], (b, chunk))

        def draw(kp):
            return weighted_neighbor(g, cumw, curw, kp)
    else:
        safe = jnp.maximum(cur, 0)
        deg = g.deg[safe]
        lo = g.row_ptr[safe].astype(jnp.int32)
        alive = (cur >= 0) & (deg > 0)

        def draw(kp):
            u = jax.random.uniform(kp, (b, chunk))
            idx = jnp.minimum(
                (u * deg[:, None]).astype(jnp.int32),
                jnp.maximum(deg - 1, 0)[:, None],
            )
            props = g.col[lo[:, None] + idx]
            return jnp.where(alive[:, None], props, -1)

    def round_(state):
        i, nxt, done = state
        kp, ka = jax.random.split(jax.random.fold_in(key, i))
        props = draw(kp)
        is_ret = props == prev[:, None]
        is_tri = edge_set_contains(eset, prev[:, None], props)
        bias = jnp.where(is_ret, inv_p, jnp.where(is_tri, 1.0, inv_q))
        acc = jax.random.uniform(ka, (b, chunk)) < (bias / qmax)
        acc = acc | (props < 0)  # dead walkers: nothing to retry
        any_acc = acc.any(axis=1)
        first = jnp.argmax(acc, axis=1)
        # accepted -> first accepted proposal; else -> last proposal of
        # this chunk (the rolling fallback)
        pick = jnp.where(any_acc, first, chunk - 1)
        cand = jnp.take_along_axis(props, pick[:, None], axis=1)[:, 0]
        nxt = jnp.where(done, nxt, cand)
        return i + 1, nxt, done | any_acc

    def cond(state):
        i, _, done = state
        frac_left = jnp.mean((~done).astype(jnp.float32))
        return (i < n_chunks) & ((i == 0) | (frac_left > residual))

    state = (jnp.int32(0), jnp.full((b,), -1, cur.dtype), jnp.zeros(b, bool))
    if n_chunks == 1:  # one-shot panel: no loop machinery to fuse around
        _, nxt, _ = round_(state)
        return nxt
    _, nxt, _ = jax.lax.while_loop(cond, round_, state)
    return nxt


def _second_order_step_exact(
    g: Graph,
    eset: EdgeSet,
    nbrs: jax.Array,
    nwts,
    prev: jax.Array,
    cur: jax.Array,
    key: jax.Array,
    inv_p: float,
    inv_q: float,
) -> jax.Array:
    safe = jnp.maximum(cur, 0)
    row = nbrs[safe]  # [B, D]
    valid = row >= 0
    is_ret = row == prev[:, None]
    is_tri = edge_set_contains(eset, prev[:, None], row)
    bias = jnp.where(is_ret, inv_p, jnp.where(is_tri, 1.0, inv_q))
    if nwts is not None:
        bias = bias * nwts[safe]
    logits = jnp.where(valid, jnp.log(bias), -jnp.inf)
    gum = jax.random.gumbel(key, row.shape)
    choice = jnp.argmax(logits + gum, axis=1)
    nxt = jnp.take_along_axis(row, choice[:, None], axis=1)[:, 0]
    alive = (cur >= 0) & (g.deg[safe] > 0)
    return jnp.where(alive, nxt, -1)


def node2vec_walks(
    g: Graph,
    starts: jax.Array,
    num_steps: int,
    p: float,
    q: float,
    key: jax.Array,
    weighted: bool = False,
    mode: str = "rejection",
    max_trials: int | None = None,
    eset: EdgeSet | None = None,
    sort_gather: bool = False,
) -> jax.Array:
    """int32[B, num_steps+1]; first hop is first-order (alias_nodes
    semantics, ``node2vec.py:28-29``), later hops second-order.

    ``max_trials=None`` sizes the proposal panel from (p, q) via
    ``default_max_trials``.  ``eset`` may be passed when calling under jit
    with a traced graph; by default it is built (and cached) host-side.
    ``sort_gather``: sort the frontier by current node each hop so the
    proposal-panel CSR gathers are monotonic in memory (statistically
    identical walks; see walks/walker.py).
    """
    starts = starts.astype(jnp.int32)
    inv_p, inv_q = 1.0 / p, 1.0 / q
    if max_trials is None:
        max_trials = default_max_trials(p, q)
    if eset is None:
        eset = edge_set(g)
    cumw = row_cumulative_weights(g) if weighted else None
    if mode == "exact":
        nbrs, nwts = padded_neighbors(g)
    else:
        nbrs, nwts = None, None

    if num_steps == 0:
        return starts[:, None]

    k0, krest = jax.random.split(key)
    if weighted:
        c1 = weighted_neighbor(g, cumw, starts, k0)
    else:
        c1 = uniform_neighbor(g, starts, k0)

    if num_steps == 1:
        return jnp.stack([starts, c1], axis=1)

    def hop(prev, cur, k):
        if mode == "exact":
            return _second_order_step_exact(
                g, eset, nbrs, nwts, prev, cur, k, inv_p, inv_q
            )
        return _second_order_step_rejection(
            g, cumw, eset, prev, cur, k, inv_p, inv_q, max_trials,
            weighted,
        )

    def step(carry, k):
        prev, cur = carry
        if sort_gather:
            order = jnp.argsort(cur)
            inv = jnp.argsort(order)
            nxt = hop(prev[order], cur[order], k)[inv]
        else:
            nxt = hop(prev, cur, k)
        nxt = jnp.where(cur < 0, -1, nxt)
        return (cur, nxt), nxt

    keys = jax.random.split(krest, num_steps - 1)
    _, cols = jax.lax.scan(step, (starts, c1), keys)
    return jnp.concatenate([starts[None, :], c1[None, :], cols], axis=0).T


def node2vec_transition_probs(
    g: Graph, prev: int, cur: int, p: float, q: float
) -> np.ndarray:
    """Host-side exact next-hop distribution over node ids (dense [V]).

    Reference semantics of ``get_alias_edge`` (``node2vec.py:61-81``) —
    the parity oracle for the statistical walk tests.
    """
    row_ptr = np.asarray(g.row_ptr)
    col = np.asarray(g.col)
    w = (
        np.ones_like(col, np.float32)
        if g.weight is None
        else np.asarray(g.weight)
    )
    lo, hi = row_ptr[cur], row_ptr[cur + 1]
    probs = np.zeros(g.n_nodes, np.float64)
    prev_nbrs = set(col[row_ptr[prev] : row_ptr[prev + 1]].tolist())
    for e in range(lo, hi):
        x = int(col[e])
        if x == prev:
            b = w[e] / p
        elif x in prev_nbrs:  # undirected: edge(x, prev) == edge(prev, x)
            b = w[e]
        else:
            b = w[e] / q
        probs[x] += b
    s = probs.sum()
    return probs / s if s > 0 else probs
