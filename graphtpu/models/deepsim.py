"""DeepSim — autoencoder over SimRank-valued walk windows.

Reference (``DeepSim/src/DeepSim.py:111-195,268-342``): a one-hidden-layer
AE |V| -> d -> |V|; the input is the one-hot of a walk-window center, the
target is a |V|-vector holding simrank(center, j) at the 2k+1 window
positions (pairs missing from the top-k sim list get the center's minimum
known sim, ``tem_simrank``); softmax cross-entropy on the raw (unnormalised)
simrank labels; Adam lr=1e-3, minibatch 128, 50k iters; the embedding is
the W1 row matrix (checkpointed every 1000 iters, ``DeepSim.py:182-189``).

Accelerator re-design, same math, none of the pathologies:
  * the one-hot matmul x @ W1 is a row gather W1[center] (SURVEY.md §7.9) —
    no [B, V] one-hot batches built in Python;
  * sim lookup per (center, window-node) is a vectorised bisection over the
    id-sorted top-k arrays (the reference's binary search at
    ``DeepSim.py:297-318``);
  * note: the reference indexes ``tem_simrank[location]`` (walk *position*)
    at ``DeepSim.py:321`` — an indexing bug; we implement the evident
    intent ``tem_simrank[center]``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from graphtpu.core.config import DeepSimConfig

SimTable = Tuple[jax.Array, jax.Array, jax.Array]  # ids [V,K], vals [V,K], min [V]


def build_sim_table(
    sim_dict: Dict[int, List[Tuple[int, float]]], n_nodes: int, k_max: int = 0
) -> SimTable:
    """Pack {src: [(nbr, sim), ...]} into id-sorted padded device arrays.

    Mirrors the reference prep: drop sims <= 1e-8 (``main.py:100-104``),
    sort by neighbour id for bisection (``main.py:413-414``), per-node
    minimum sim as the fallback label (``tem_simrank``, ``main.py:407-412``).
    """
    if k_max <= 0:
        k_max = max((len(v) for v in sim_dict.values()), default=1)
    ids = np.full((n_nodes, k_max), np.iinfo(np.int32).max, np.int32)
    vals = np.zeros((n_nodes, k_max), np.float32)
    mins = np.zeros((n_nodes,), np.float32)
    for src, pairs in sim_dict.items():
        pairs = [(i, v) for i, v in pairs if v > 1e-8][:k_max]
        if not pairs:
            continue
        pairs.sort()
        ids[src, : len(pairs)] = [i for i, _ in pairs]
        vals[src, : len(pairs)] = [v for _, v in pairs]
        mins[src] = min(v for _, v in pairs)
    return jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(mins)


def lookup_sim(table: SimTable, src: jax.Array, dst: jax.Array) -> jax.Array:
    """sim(src, dst) with min-sim fallback; src [B], dst [B, W]."""
    ids, vals, mins = table
    rows_i = ids[src]                      # [B, K]
    rows_v = vals[src]
    pos = jax.vmap(jnp.searchsorted)(rows_i, dst)  # [B, W]
    pos_c = jnp.minimum(pos, ids.shape[1] - 1)
    hit = jnp.take_along_axis(rows_i, pos_c, axis=1) == dst
    val = jnp.take_along_axis(rows_v, pos_c, axis=1)
    return jnp.where(hit, val, mins[src][:, None])


def init_params(cfg: DeepSimConfig, n_nodes: int, key: jax.Array):
    k1, k2 = jax.random.split(key)
    w1 = 0.1 * jax.random.truncated_normal(
        k1, -2.0, 2.0, (n_nodes, cfg.dim), jnp.float32
    )
    b1 = jnp.zeros((cfg.dim,), jnp.float32)
    w2 = 0.1 * jax.random.truncated_normal(
        k2, -2.0, 2.0, (cfg.dim, n_nodes), jnp.float32
    )
    b2 = jnp.zeros((n_nodes,), jnp.float32)
    return (w1, b1, w2, b2)


def deepsim_loss(
    params,
    centers: jax.Array,        # [B]
    window_ids: jax.Array,     # [B, 2k+1] node ids in the window
    window_vals: jax.Array,    # [B, 2k+1] simrank labels
):
    """softmax CE between full-vocab logits and the sparse simrank target.

    Equals tf.nn.softmax_cross_entropy_with_logits with the dense |V|
    target that holds window_vals at window_ids and 0 elsewhere (window
    duplicates accumulate, matching the dense construction).
    """
    w1, b1, w2, b2 = params
    hidden = jax.nn.relu(w1[centers] + b1)          # == relu(onehot @ W1 + b1)
    logits = hidden @ w2 + b2                       # [B, V]
    logz = jax.nn.log_softmax(logits, axis=-1)
    picked = jnp.take_along_axis(logz, window_ids, axis=1)
    ce = -(window_vals * picked).sum(axis=1)
    return ce.mean()


def train_deepsim(
    walks: np.ndarray,
    sim_table: SimTable,
    n_nodes: int,
    cfg: DeepSimConfig = DeepSimConfig(),
    key: Optional[jax.Array] = None,
    steps: Optional[int] = None,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
) -> np.ndarray:
    """Returns the embedding = W1 [V, dim].

    ``checkpoint_fn(step, emb)`` mirrors the reference's every-1000-iters
    embedding dumps (``DeepSim.py:182-186``)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    steps = cfg.steps if steps is None else steps
    walks = jnp.asarray(np.asarray(walks), jnp.int32)
    wn, ln = walks.shape
    k = cfg.window
    assert ln > 2 * k, "walk length must exceed the window"

    params = init_params(cfg, n_nodes, jax.random.fold_in(key, 0))
    opt = optax.adam(cfg.learning_rate)
    opt_state = opt.init(params)
    offs = jnp.arange(-k, k + 1)

    @jax.jit
    def step(params, opt_state, kk):
        kw, kp = jax.random.split(kk)
        wi = jax.random.randint(kw, (cfg.minibatch,), 0, wn)
        pos = jax.random.randint(kp, (cfg.minibatch,), k, ln - k)
        centers = walks[wi, pos]
        win = walks[wi[:, None], pos[:, None] + offs[None, :]]
        win = jnp.where(win >= 0, win, centers[:, None])  # dead-end guard
        vals = lookup_sim(sim_table, centers, win)
        # the reference's dense target writes each node id once even if it
        # repeats inside the window (``if str(j) in output`` over unique
        # ids, DeepSim.py:327-338) — zero out duplicate occurrences
        dup = (win[:, :, None] == win[:, None, :]) & (
            jnp.arange(2 * k + 1)[None, :, None]
            > jnp.arange(2 * k + 1)[None, None, :]
        )
        vals = jnp.where(dup.any(axis=2), 0.0, vals)
        loss, grads = jax.value_and_grad(deepsim_loss)(
            params, centers, win, vals
        )
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    # chunk the step loop into one scanned executable per CHUNK steps:
    # per-step dispatch would dominate a 50k-iter at-budget run, and the
    # chunk boundary is where a checkpoint is taken
    chunk = max(1, min(checkpoint_every or 200, 200))

    @partial(jax.jit, static_argnums=(3,))
    def run_chunk(params, opt_state, start, m):
        def body(carry, i):
            p, o = carry
            p, o, loss = step(p, o, jax.random.fold_in(key, i + 1))
            return (p, o), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), start + jnp.arange(m)
        )
        return params, opt_state, losses[-1]

    i = 0
    while i < steps:
        m = min(chunk, steps - i)
        params, opt_state, loss = run_chunk(
            params, opt_state, jnp.int32(i), m
        )
        if (
            checkpoint_every
            and checkpoint_fn
            and (i // checkpoint_every) != ((i + m) // checkpoint_every)
        ):
            checkpoint_fn(i + m - 1, np.asarray(params[0]))
        i += m
    return np.asarray(params[0])
