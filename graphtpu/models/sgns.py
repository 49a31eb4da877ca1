"""Skip-gram with negative sampling (SGNS) — the node2vec trainer.

The reference delegates this to gensim ``Word2Vec(walks, size=dims,
window=10, min_count=0, sg=1, workers=8, iter=10)`` whose native C inner
loop runs hogwild SGD over 8 CPU threads (``node2vec/src/main.py:92-101``).
This is the accelerator replacement, matching gensim-0.13.3 semantics:

  * dynamic windows — per center, the effective window b ~ U{1..window}
  * negative sampling — 5 draws from the unigram^0.75 table over the walk
    corpus (counts of nodes in walks), accidental hits on the true context
    masked out
  * frequent-token subsampling — gensim ``sample=1e-3``: token kept with
    prob (sqrt(f/s)+1)*s/f; sentences are *compacted* (windows span the
    gaps), re-rolled per epoch
  * linear LR decay alpha -> min_alpha over the whole run
  * loss: log sigma(v_c . u_o) + sum_neg log sigma(-v_c . u_n); SGD

Instead of hogwild races we do synchronous minibatch SGD: each step gathers
[B] centers x [2*window] contexts x [neg] negatives, computes the dots as
batched matmuls, and XLA turns the parameter gradients into segment scatter-adds.
One epoch = one shuffled pass over every (walk, position) center slot, like
gensim's stream.  Embedding = the input table (syn0).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphtpu.core.config import SGNSConfig


def corpus_counts(walks: jax.Array, n_nodes: int) -> jax.Array:
    """Token counts over the walk corpus (gensim builds its vocab from the
    walks, not the graph)."""
    flat = walks.reshape(-1)
    return jnp.bincount(
        jnp.where(flat >= 0, flat, n_nodes), length=n_nodes + 1
    )[:n_nodes]


def build_negative_cdf(counts: jax.Array, exponent: float = 0.75) -> jax.Array:
    """Cumulative unigram^0.75 table (gensim's negative-sampling table as a
    searchsorted cdf rather than a 100M-slot array)."""
    w = jnp.power(counts.astype(jnp.float32), exponent)
    return jnp.cumsum(w)


def build_negative_alias(
    counts, exponent: float = 0.75
) -> Tuple[jax.Array, jax.Array]:
    """Walker alias table for the unigram^exponent distribution.

    One draw = one uniform index + one gather + one compare — O(1) per
    sample on device, replacing the log(V) ``searchsorted`` binary search
    whose ``while`` loop serialises the step.  The
    table is built host-side once per run (V-sized, trivial cost), like
    gensim precomputes its negative table.
    """
    from graphtpu.walks.alias import alias_setup

    w = np.power(np.asarray(counts, np.float64), exponent)
    s = w.sum()
    if s <= 0:
        w[:] = 1.0
        s = float(len(w))
    j, q = alias_setup(w / s)
    return jnp.asarray(j, jnp.int32), jnp.asarray(q, jnp.float32)


def alias_draw_batch(
    j: jax.Array, q: jax.Array, key: jax.Array, shape
) -> jax.Array:
    """Vectorised alias draws: returns int32 samples of ``shape``."""
    k_idx, k_acc = jax.random.split(key)
    idx = jax.random.randint(k_idx, shape, 0, j.shape[0], dtype=jnp.int32)
    u = jax.random.uniform(k_acc, shape)
    return jnp.where(u < q[idx], idx, j[idx]).astype(jnp.int32)


def subsample_and_compact(
    walks: jax.Array, counts: jax.Array, sample: float, key: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Drop frequent tokens and compact each walk row (gensim semantics).

    Returns (compacted walks with -1 tail padding, valid-token mask).
    """
    if sample <= 0:
        return walks, walks >= 0
    total = jnp.maximum(counts.sum(), 1)
    freq = counts.astype(jnp.float32) / total
    keep_p = jnp.clip(
        (jnp.sqrt(freq / sample) + 1.0) * sample / jnp.maximum(freq, 1e-12),
        0.0,
        1.0,
    )
    valid = walks >= 0
    tok = jnp.maximum(walks, 0)
    keep = (jax.random.uniform(key, walks.shape) < keep_p[tok]) & valid
    # stable compaction: kept tokens first, original order preserved
    w = walks.shape[1]
    pos = jnp.arange(w)[None, :]
    sort_key = jnp.where(keep, pos, pos + w)
    order = jnp.argsort(sort_key, axis=1)
    compacted = jnp.take_along_axis(jnp.where(keep, walks, -1), order, axis=1)
    return compacted, compacted >= 0


def sgns_loss(
    params: Tuple[jax.Array, jax.Array],
    centers: jax.Array,      # [B]
    contexts: jax.Array,     # [B, W2]
    ctx_mask: jax.Array,     # [B, W2] bool
    negatives: jax.Array,    # [B, W2, N] per-pair (gensim) or [B, N] shared
) -> jax.Array:
    syn0, syn1 = params
    v = syn0[jnp.maximum(centers, 0)]                  # [B, D]
    u = syn1[jnp.maximum(contexts, 0)]                 # [B, W2, D]
    un = syn1[negatives]                               # [..., N, D]
    pos_logit = jnp.einsum(
        "bd,bwd->bw", v, u, preferred_element_type=jnp.float32
    )
    m = ctx_mask & (centers >= 0)[:, None]
    pos_l = jax.nn.log_sigmoid(pos_logit) * m
    if negatives.ndim == 3:
        neg_logit = jnp.einsum(
            "bd,bwnd->bwn", v, un, preferred_element_type=jnp.float32
        )
        # accidental negatives equal to the true context (or the center)
        # are skipped, as gensim does
        neg_mask = (negatives != contexts[..., None]) & (
            negatives != centers[:, None, None]
        )
        neg_l = jax.nn.log_sigmoid(-neg_logit) * (m[..., None] & neg_mask)
        neg_sum = neg_l.sum()
    else:
        # shared negatives: each pair (w, n) contributes the same
        # log sigma(-v.u_n), masked per pair -> coefficient = count of
        # valid (non-accidental) window slots
        neg_logit = jnp.einsum(
            "bd,bnd->bn", v, un, preferred_element_type=jnp.float32
        )
        coeff = (
            m[:, :, None]
            & (negatives[:, None, :] != contexts[..., None])
            & (negatives != centers[:, None])[:, None, :]
        ).sum(axis=1)                                   # [B, N]
        neg_sum = (jax.nn.log_sigmoid(-neg_logit) * coeff).sum()
    # SUM, not mean: combined with the per-row collision normalisation in
    # the update (see train_sgns), one batched step reproduces the
    # magnitude of gensim's sequential per-pair SGD updates.
    return -(pos_l.sum() + neg_sum)


def sgns_manual_grads(
    params: Tuple[jax.Array, jax.Array],
    centers: jax.Array,
    contexts: jax.Array,
    ctx_mask: jax.Array,
    negatives: jax.Array,
    n_nodes: int,
):
    """Closed-form SGNS gradients with sort-based row aggregation.

    Equals jax.grad(sgns_loss) but replaces the million-row scatter-adds
    XLA emits for embedding-table gradients (colliding rows serialise) with
    :func:`graphtpu.kernels.topk.segment_rows_sum`.  Also returns the
    per-row occurrence counts used for collision normalisation (free from
    the same pass).  Returns ((g0, g1), (c0, c1)).
    """
    from graphtpu.kernels.topk import segment_rows_sum

    syn0, syn1 = params
    v = syn0[jnp.maximum(centers, 0)]                 # [B, D]
    u = syn1[jnp.maximum(contexts, 0)]                # [B, W, D]
    un = syn1[negatives]                              # [..., N, D]
    pos_logit = jnp.einsum("bd,bwd->bw", v, u, preferred_element_type=jnp.float32)
    m = (ctx_mask & (centers >= 0)[:, None]).astype(jnp.float32)
    # d(-log sigma(x))/dx = sigma(x) - 1 ; d(-log sigma(-x))/dx = sigma(x)
    g_pos = (jax.nn.sigmoid(pos_logit) - 1.0) * m          # [B, W]
    du = g_pos[..., None] * v[:, None, :]                  # [B, W, D]
    if negatives.ndim == 3:
        neg_logit = jnp.einsum(
            "bd,bwnd->bwn", v, un, preferred_element_type=jnp.float32
        )
        neg_mask = (negatives != contexts[..., None]) & (
            negatives != centers[:, None, None]
        )
        mn = m[..., None] * neg_mask.astype(jnp.float32)
        g_neg = jax.nn.sigmoid(neg_logit) * mn             # [B, W, N]
        dv = jnp.einsum("bw,bwd->bd", g_pos, u) + jnp.einsum(
            "bwn,bwnd->bd", g_neg, un
        )
        dun = g_neg[..., None] * v[:, None, None, :]       # [B, W, N, D]
    else:
        neg_logit = jnp.einsum(
            "bd,bnd->bn", v, un, preferred_element_type=jnp.float32
        )
        coeff = (
            (m[:, :, None] > 0)
            & (negatives[:, None, :] != contexts[..., None])
            & (negatives != centers[:, None])[:, None, :]
        ).sum(axis=1).astype(jnp.float32)                  # [B, N]
        g_neg = jax.nn.sigmoid(neg_logit) * coeff          # [B, N]
        dv = jnp.einsum("bw,bwd->bd", g_pos, u) + jnp.einsum(
            "bn,bnd->bd", g_neg, un
        )
        dun = g_neg[..., None] * v[:, None, :]             # [B, N, D]

    d = syn0.shape[1]
    g0, c0 = segment_rows_sum(centers, dv, n_nodes)
    idx1 = jnp.concatenate(
        [
            jnp.where(ctx_mask, contexts, -1).reshape(-1),
            negatives.reshape(-1),
        ]
    )
    rows1 = jnp.concatenate(
        [du.reshape(-1, d), dun.reshape(-1, d)], axis=0
    )
    g1, c1 = segment_rows_sum(idx1, rows1, n_nodes)
    return (g0, g1), (c0, c1)


def _gather_batch(
    walks: jax.Array,       # [W, L] compacted
    slots: jax.Array,       # [B] flat center slot ids (walk*L + pos)
    window: int,
    key: jax.Array,
):
    wn, ln = walks.shape
    wi, pos = slots // ln, slots % ln
    centers = walks[wi, pos]
    b = jax.random.randint(key, (slots.shape[0],), 1, window + 1)  # dynamic window
    offs = jnp.concatenate(
        [jnp.arange(-window, 0), jnp.arange(1, window + 1)]
    )                                                   # [2w]
    cpos = pos[:, None] + offs[None, :]
    inb = (cpos >= 0) & (cpos < ln) & (jnp.abs(offs)[None, :] <= b[:, None])
    contexts = walks[wi[:, None], jnp.clip(cpos, 0, ln - 1)]
    mask = inb & (contexts >= 0)
    return centers, contexts, mask


def train_sgns(
    walks: jax.Array,
    n_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    key: Optional[jax.Array] = None,
    counts: Optional[jax.Array] = None,
    chunk_steps: int = 200,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train on a [W, L] walk tensor; returns (syn0, syn1) as numpy [V, D].

    Matches the reference training budget: ``cfg.epochs`` passes over every
    center slot (gensim iter=10), LR decaying linearly across the run.

    ``mesh``: optional multi-device mesh ('data' and optionally 'model'
    axes).  The same math runs data-parallel over the batch axis with the
    embedding tables row-sharded over 'model' (the synchronous-DP hogwild
    replacement, SURVEY.md §2.3) — GSPMD inserts the psums/gathers, and a
    mesh run reproduces the single-device trajectory (tested to 1e-5,
    modulo reduction order).
    """
    if key is None:
        key = jax.random.key(cfg.seed)
    wn, ln = walks.shape
    if counts is None:
        counts = corpus_counts(walks, n_nodes)
    neg_j, neg_q = build_negative_alias(counts, cfg.ns_exponent)

    k_init, k_run = jax.random.split(key)
    # gensim init: syn0 ~ U(-0.5/d, 0.5/d), syn1neg = 0
    syn0 = (
        jax.random.uniform(k_init, (n_nodes, cfg.dim), jnp.float32) - 0.5
    ) / cfg.dim
    syn1 = jnp.zeros((n_nodes, cfg.dim), jnp.float32)

    slots_per_epoch = wn * ln
    # collision normalisation (below) makes per-epoch row movement scale
    # like V/B relative to gensim's sequential SGD, so cap the batch near
    # the vocabulary size to keep small-graph training gensim-equivalent.
    batch = min(cfg.batch_size, slots_per_epoch, max(64, n_nodes))

    data_sh = model_sh = repl = None
    n_tab = n_nodes  # table rows: padded to divide the 'model' axis
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = mesh.axis_names
        n_data = mesh.shape[axes[0]]
        batch = max(n_data, batch - batch % n_data)
        data_sh = NamedSharding(mesh, P(axes[0]))
        model_axis = axes[1] if len(axes) > 1 else None
        model_sh = NamedSharding(mesh, P(model_axis, None))
        repl = NamedSharding(mesh, P())
        if model_axis is not None:
            n_model = mesh.shape[model_axis]
            n_tab = -(-n_nodes // n_model) * n_model
    steps_per_epoch = slots_per_epoch // batch
    total_steps = max(cfg.epochs * steps_per_epoch, 1)

    # Steps are scanned in bounded chunks; the chunk boundary is where a
    # checkpoint can be taken (``checkpoint_every``).
    chunk = max(1, min(chunk_steps, steps_per_epoch))

    # walks and counts are arguments, not closure constants: a captured
    # corpus is folded into the executable at compile time
    @jax.jit
    def prep_epoch(walks, counts, ekey):
        k_sub, k_perm = jax.random.split(ekey)
        cwalks, _ = subsample_and_compact(walks, counts, cfg.subsample, k_sub)
        perm = jax.random.permutation(k_perm, slots_per_epoch)
        return cwalks, perm

    def _constrain(x, sh):
        return x if sh is None else jax.lax.with_sharding_constraint(x, sh)

    @partial(jax.jit, donate_argnums=(0,), static_argnums=(6,))
    def run_chunk(params, cwalks, perm, epoch_idx, ckey, start_step, n_steps):
        def step(params, it):
            i, kk = it
            k_win, k_neg = jax.random.split(kk)
            slots = jax.lax.dynamic_slice(perm, (i * batch,), (batch,))
            slots = _constrain(slots, data_sh)
            centers, contexts, mask = _gather_batch(cwalks, slots, cfg.window, k_win)
            nshape = (
                (batch, cfg.negative)
                if cfg.shared_negatives
                else (batch, 2 * cfg.window, cfg.negative)
            )
            negs = alias_draw_batch(neg_j, neg_q, k_neg, nshape)
            if mesh is not None:
                # data-parallel pair batch; tables row-sharded over 'model'
                centers = _constrain(centers, data_sh)
                params = tuple(_constrain(p, model_sh) for p in params)
            gstep = epoch_idx * steps_per_epoch + i
            lr = cfg.alpha - (cfg.alpha - cfg.min_alpha) * gstep / total_steps
            # manual gradients + sort-based row aggregation (no large
            # scatter; see sgns_manual_grads).  Collision normalisation:
            # a row hit k times in one batch gets its summed gradient
            # divided by k, so the per-occurrence step matches gensim's
            # sequential update magnitude regardless of batch size /
            # vocabulary size (stability on tiny vocabs).
            (g0, g1), (c0, c1) = sgns_manual_grads(
                params, centers, contexts, mask, negs, n_tab
            )
            g0 = g0 / jnp.maximum(c0, 1)[:, None]
            g1 = g1 / jnp.maximum(c1, 1)[:, None]
            syn0, syn1 = params
            return (syn0 - lr * g0, syn1 - lr * g1), None

        keys = jax.random.split(ckey, n_steps)
        params, _ = jax.lax.scan(
            step, params, (start_step + jnp.arange(n_steps), keys)
        )
        return params

    if mesh is not None:
        # pad rows are never referenced (ids < n_nodes): zero gradients
        pad = ((0, n_tab - n_nodes), (0, 0))
        syn0 = jax.device_put(jnp.pad(syn0, pad), model_sh)
        syn1 = jax.device_put(jnp.pad(syn1, pad), model_sh)
    params = (syn0, syn1)
    resume_epoch, resume_start = 0, 0
    if checkpoint_path:
        import os

        from graphtpu.models.checkpoint import load_state, save_state

        if os.path.exists(checkpoint_path):
            arrays, _, meta = load_state(checkpoint_path)
            params = (jnp.asarray(arrays["syn0"]), jnp.asarray(arrays["syn1"]))
            resume_epoch = meta.get("epoch", 0)
            resume_start = meta.get("next_start", 0)

    done_chunks = 0
    for e in range(resume_epoch, cfg.epochs):
        ekey = jax.random.fold_in(k_run, e)
        cwalks, perm = prep_epoch(walks, counts, ekey)
        start0 = resume_start if e == resume_epoch else 0
        for start in range(start0, steps_per_epoch, chunk):
            # PRNG streams key off (epoch, start), so a resumed run
            # reproduces the uninterrupted trajectory exactly
            params = run_chunk(
                params, cwalks, perm, e, jax.random.fold_in(ekey, start),
                start, min(chunk, steps_per_epoch - start),
            )
            done_chunks += 1
            nxt = start + chunk
            if checkpoint_path and checkpoint_every and (
                done_chunks % checkpoint_every == 0
            ):
                meta = (
                    {"epoch": e, "next_start": nxt}
                    if nxt < steps_per_epoch
                    else {"epoch": e + 1, "next_start": 0}
                )
                save_state(
                    checkpoint_path,
                    {"syn0": np.asarray(params[0]), "syn1": np.asarray(params[1])},
                    step=done_chunks,
                    meta=meta,
                )
    syn0, syn1 = params
    return np.asarray(syn0)[:n_nodes], np.asarray(syn1)[:n_nodes]
