"""Top-k extraction and bounded top-k accumulation.

Two layers, matching the two ways the reference keeps similarity rows:

* dense rows + final heap extraction — ``Print.printByOrder`` builds a
  FixedMaxPQ per row (``utils/Print.java:25-53``).  Our
  :func:`topk_rows` is ``lax.top_k`` over a [B, V] tile, plus an optional
  streamed merge across tiles (:func:`merge_topk`) so no dense V x V state
  ever exists — the device form of the reference's batched-source windows
  (``giraph/BatchSingleWalkVertex.java:108-133``).

* bounded in-flight accumulators — ``lxctools/FixedCacheMap`` accumulates
  into capacity-bounded min-heaps during the walk (``FixedCacheMap.java:
  32-50``: accumulate if present, insert if not full, else replace the min
  iff the new value beats it).  :func:`bounded_topk_accumulate` reproduces
  those exact semantics vectorised over sources (a scan over items with
  masked scatter), for scale regimes where dense rows don't fit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def topk_rows(
    scores: jax.Array,
    k: int,
    exclude_diag_offset: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """(values, indices) of the k largest entries per row of [B, V].

    ``exclude_diag_offset=r`` masks column ``r + i`` in row i (the
    "sim(v,v)=0" post-processing of ``SimRank.java:62-65`` when row i is
    global source r+i).
    """
    if exclude_diag_offset is not None:
        b, v = scores.shape
        rows = jnp.arange(b)
        scores = scores.at[rows, exclude_diag_offset + rows].set(-jnp.inf)
    k_eff = min(k, scores.shape[-1])
    vals, idx = jax.lax.top_k(scores, k_eff)
    idx = idx.astype(jnp.int32)
    if k_eff < k:  # pad to the requested width (idx -1, val 0)
        pad = ((0, 0),) * (vals.ndim - 1) + ((0, k - k_eff),)
        vals = jnp.pad(vals, pad)
        idx = jnp.pad(idx, pad, constant_values=-1)
    return vals, idx


def merge_topk(
    vals_a: jax.Array, idx_a: jax.Array, vals_b: jax.Array, idx_b: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Merge two per-row top-k sets into one (streamed tile reduction)."""
    vals = jnp.concatenate([vals_a, vals_b], axis=1)
    idx = jnp.concatenate([idx_a, idx_b], axis=1)
    mv, mi = jax.lax.top_k(vals, k)
    return mv, jnp.take_along_axis(idx, mi, axis=1)


def segment_topk(
    targets: jax.Array,
    values: jax.Array,
    k: int,
    n_classes: int,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k of per-target sums from an item stream — scatter-free.

    ``targets``/``values``: [T, N] items per source (target < 0 = skip).
    Returns (vals [T, k] descending, idx [T, k], -1 padded).

    Scatter-free accumulation: sort items by target (a vectorised sort
    instead of conflicting scatter-adds), prefix-sum the values, read run
    totals at run boundaries, then ``lax.top_k`` — the whole UniWalk/TopSim
    "accumulate into a row then extract top-k" flow without materialising
    a [T, V] tile or issuing a single scatter.
    """
    t, n = targets.shape
    tt = jnp.where(targets >= 0, targets, n_classes).astype(jnp.int32)
    st, sv = jax.lax.sort((tt, values.astype(jnp.float32)), num_keys=1)
    csum = jnp.cumsum(sv, axis=1)
    # run end: last item of each equal-target run
    is_end = jnp.concatenate(
        [st[:, :-1] != st[:, 1:], jnp.ones((t, 1), bool)], axis=1
    )
    # total of the run ending at i: csum[i] - csum[end of previous run];
    # the previous run end is found with a cummax over masked positions
    pos = jnp.arange(n)
    prev_end_idx = jnp.where(
        jnp.concatenate([jnp.zeros((t, 1), bool), is_end[:, :-1]], axis=1),
        pos[None, :] - 1,
        -1,
    )
    prev_end_idx = jax.lax.cummax(prev_end_idx, axis=1)
    base = jnp.where(
        prev_end_idx >= 0,
        jnp.take_along_axis(csum, jnp.maximum(prev_end_idx, 0), axis=1),
        0.0,
    )
    run_total = csum - base
    cand = jnp.where(is_end & (st < n_classes), run_total, -jnp.inf)
    vals, pos_k = jax.lax.top_k(cand, min(k, n))
    idx = jnp.take_along_axis(st, pos_k, axis=1)
    ok = jnp.isfinite(vals)
    vals = jnp.where(ok, vals, 0.0).astype(values.dtype)
    idx = jnp.where(ok, idx, -1)
    if min(k, n) < k:
        pad = ((0, 0), (0, k - min(k, n)))
        vals = jnp.pad(vals, pad)
        idx = jnp.pad(idx, pad, constant_values=-1)
    return vals, idx


def segment_sum_1d(
    ids: jax.Array,
    vals: jax.Array,
    n_segments: int,
) -> jax.Array:
    """[n_segments] sums of ``vals`` grouped by ``ids`` — zero scatters.

    ids < 0 are skipped.  Sort by id, prefix-sum, then *gather* each
    segment's boundary totals with two searchsorted lookups; the inverse
    of the scatter-add formulation, entirely gather-based (scatters whose
    update rows collide serialise; gathers don't).
    """
    n = ids.shape[0]
    safe = jnp.where(ids >= 0, ids, n_segments).astype(jnp.int32)
    si, sv = jax.lax.sort((safe, vals.astype(jnp.float32)), num_keys=1)
    csum = jnp.cumsum(sv)
    seg = jnp.arange(n_segments, dtype=jnp.int32)
    right = jnp.searchsorted(si, seg, side="right")
    left = jnp.searchsorted(si, seg, side="left")
    hi = jnp.where(right > 0, csum[jnp.maximum(right - 1, 0)], 0.0)
    lo = jnp.where(left > 0, csum[jnp.maximum(left - 1, 0)], 0.0)
    return jnp.where(right > left, hi - lo, 0.0).astype(vals.dtype)


def pair_topk_by_source(
    srcs: jax.Array,
    tgts: jax.Array,
    vals: jax.Array,
    source_ids: jax.Array,
    k: int,
    counts: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-source top-k of per-(src, tgt) sums from a flat item stream.

    The scatter-free production accumulator for path-reuse flows, where a
    walk offset makes *any* node a source (``SingleRandomWalkOptimal2
    .java:49-64``) so items cannot be pre-grouped into per-source panels.
    Replaces both the element-wise [V, V] scatter accumulation and the
    sequential FixedCacheMap scan for at-scale runs: the bounded-memory
    semantics the reference needed a capacity-C min-heap for
    (``lxctools/FixedCacheMap.java:32-50``) falls out of sort + top-k.

    ``srcs``/``tgts``/``vals``: [N] items (src or tgt < 0 = skip).
    ``source_ids``: [M] ascending source ids to emit rows for.
    ``counts``: optional [max_source+1] per-source normaliser applied to
    the summed values (the Giraph flush normalisation).
    Returns (vals [M, k] descending, idx [M, k], -1 padded).

    Pipeline (no scatter anywhere):
      1. sort items by (src, tgt)           — one multi-key bitonic sort
      2. prefix-sum + boundary diff         — per-pair run totals
      3. sort pair totals by (src, -total)  — per-source descending order
      4. searchsorted + gather              — each source's first k entries
    """
    n = srcs.shape[0]
    big = jnp.int32(2**31 - 1)
    valid = (srcs >= 0) & (tgts >= 0)
    s_c = jnp.where(valid, srcs, big).astype(jnp.int32)
    t_c = jnp.where(valid, tgts, big).astype(jnp.int32)
    s1, t1, v1 = jax.lax.sort(
        (s_c, t_c, vals.astype(jnp.float32)), num_keys=2
    )
    csum = jnp.cumsum(v1)
    is_end = jnp.concatenate(
        [(s1[:-1] != s1[1:]) | (t1[:-1] != t1[1:]), jnp.ones((1,), bool)]
    )
    pos = jnp.arange(n)
    prev_end = jax.lax.cummax(
        jnp.where(
            jnp.concatenate([jnp.zeros((1,), bool), is_end[:-1]]), pos - 1, -1
        )
    )
    base = jnp.where(prev_end >= 0, csum[jnp.maximum(prev_end, 0)], 0.0)
    total = csum - base
    if counts is not None:
        total = total / jnp.maximum(counts[jnp.minimum(s1, counts.shape[0] - 1)], 1.0)
    live = is_end & (s1 != big)
    neg = jnp.where(live, -total, jnp.inf)
    s2, neg2, t2 = jax.lax.sort(
        (jnp.where(live, s1, big), neg, t1), num_keys=2
    )
    left = jnp.searchsorted(s2, source_ids.astype(jnp.int32), side="left")
    take = jnp.minimum(left[:, None] + jnp.arange(k)[None, :], n - 1)
    row_src = s2[take]
    row_val = -neg2[take]
    ok = (row_src == source_ids[:, None]) & jnp.isfinite(row_val)
    out_vals = jnp.where(ok, row_val, 0.0)
    out_idx = jnp.where(ok, t2[take], -1)
    return out_vals, out_idx


def segment_rows_sum(
    idx: jax.Array,
    rows: jax.Array,
    n_segments: int,
) -> Tuple[jax.Array, jax.Array]:
    """Sum [N, D] rows by segment id — scatter-minimised.

    Returns (sums [n_segments, D], counts [n_segments]).  idx < 0 rows are
    skipped.  A scatter-add with many colliding update rows serialises
    (the classic embedding-gradient cliff); here the N-row scatter becomes:
    sort by id, prefix-sum, read run totals at boundaries, compact the
    (<= n_segments) boundary rows forward, and do ONE small scatter of
    n_segments rows.
    """
    n, d = rows.shape
    safe = jnp.where(idx >= 0, idx, n_segments).astype(jnp.int32)
    order = jnp.argsort(safe)
    si = safe[order]
    sr = rows[order]
    csum = jnp.cumsum(sr, axis=0, dtype=jnp.float32)
    is_end = jnp.concatenate([si[:-1] != si[1:], jnp.ones((1,), bool)])
    pos = jnp.arange(n)
    prev_end_idx = jax.lax.cummax(
        jnp.where(jnp.concatenate([jnp.zeros((1,), bool), is_end[:-1]]), pos - 1, -1)
    )
    base = jnp.where(
        (prev_end_idx >= 0)[:, None],
        csum[jnp.maximum(prev_end_idx, 0)],
        0.0,
    )
    totals = csum - base
    # run length so far, from positions alone.  Not a cumsum of ones: XLA
    # may constant-fold that reduce-window on the host in O(n²) time
    # (minutes at n ~ 2e5 under SPMD partitioning)
    counts = (pos - prev_end_idx).astype(jnp.float32)
    # compact boundary rows to the front (stable sort on end-id), then one
    # scatter of at most n_segments rows
    end_id = jnp.where(is_end & (si < n_segments), si, n_segments)
    ord2 = jnp.argsort(end_id)
    take = min(n, n_segments)
    top = ord2[:take]
    out = jnp.zeros((n_segments + 1, d), jnp.float32)
    out = out.at[end_id[top]].set(totals[top], mode="drop")
    out_c = jnp.zeros((n_segments + 1,), jnp.float32)
    out_c = out_c.at[end_id[top]].set(counts[top], mode="drop")
    return out[:n_segments].astype(rows.dtype), out_c[:n_segments]


def segment_rows_sum_matmul(
    idx: jax.Array,
    rows: jax.Array,
    n_segments: int,
    chunk: int = 8192,
    compute_dtype=jnp.bfloat16,
) -> Tuple[jax.Array, jax.Array]:
    """Segment row-sum as chunked one-hot matmuls — pure matmul work.

    For each chunk of items: build onehot [C, S] (exact in bf16), then
    sums += onehot^T @ rows (f32 accumulation).  O(N*S*D) flops, all of it
    dense matmul, at the embedding-gradient shapes (N~2e5, S~1e4, D~128);
    not measured on a GPU against the sort-based form.  Counts come from the
    same matmul against a ones column.
    """
    n, d = rows.shape
    pad = (-n) % chunk
    if pad:
        idx = jnp.concatenate([idx, jnp.full((pad,), -1, idx.dtype)])
        rows = jnp.concatenate([rows, jnp.zeros((pad, d), rows.dtype)])
        n += pad
    seg_ids = jnp.arange(n_segments, dtype=jnp.int32)
    sums = jnp.zeros((n_segments, d), jnp.float32)
    counts = jnp.zeros((n_segments,), jnp.float32)
    rows_aug = jnp.concatenate(
        [rows.astype(compute_dtype), jnp.ones((n, 1), compute_dtype)], axis=1
    )
    for lo in range(0, n, chunk):
        ci = jax.lax.dynamic_slice(idx, (lo,), (chunk,))
        cr = jax.lax.dynamic_slice(rows_aug, (lo, 0), (chunk, d + 1))
        onehot = (ci[:, None] == seg_ids[None, :]).astype(compute_dtype)
        acc = jax.lax.dot_general(
            onehot, cr,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [S, D+1]
        sums = sums + acc[:, :d]
        counts = counts + acc[:, d]
    return sums.astype(rows.dtype), counts


def bounded_topk_accumulate(
    keys: jax.Array,
    values: jax.Array,
    capacity: int,
    init_keys: Optional[jax.Array] = None,
    init_values: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """FixedCacheMap.put semantics over an item stream, per source.

    ``keys``/``values``: [B, N] item streams (key < 0 = skip).  Returns
    (slot_keys [B, C], slot_values [B, C]) with -1 in empty key slots.
    Exact reference semantics (``FixedCacheMap.java:32-50``): items are
    processed in order; an existing key accumulates; a new key fills an
    empty slot; once full, a new key evicts the current minimum only if its
    value is strictly greater.
    """
    b, n = keys.shape
    if init_keys is None:
        slot_k = jnp.full((b, capacity), -1, jnp.int32)
        slot_v = jnp.zeros((b, capacity), values.dtype)
    else:
        slot_k, slot_v = init_keys, init_values

    def step(carry, item):
        sk, sv = carry
        k_i, v_i = item  # [B], [B]
        valid = k_i >= 0
        match = sk == k_i[:, None]  # [B, C]
        present = match.any(axis=1)
        # 1) accumulate where present
        sv = sv + jnp.where(match & valid[:, None], v_i[:, None], 0)
        # 2) insert into first empty slot when absent and not full
        empty = sk < 0
        has_empty = empty.any(axis=1)
        first_empty = jnp.argmax(empty, axis=1)
        do_insert = valid & ~present & has_empty
        rows = jnp.arange(b)
        sk = sk.at[rows, first_empty].set(
            jnp.where(do_insert, k_i, sk[rows, first_empty])
        )
        sv = sv.at[rows, first_empty].set(
            jnp.where(do_insert, v_i, sv[rows, first_empty])
        )
        # 3) evict min when absent and full and v > min
        occupied_v = jnp.where(sk >= 0, sv, jnp.inf)
        minpos = jnp.argmin(occupied_v, axis=1)
        minval = occupied_v[rows, minpos]
        do_evict = valid & ~present & ~has_empty & (v_i > minval)
        sk = sk.at[rows, minpos].set(jnp.where(do_evict, k_i, sk[rows, minpos]))
        sv = sv.at[rows, minpos].set(jnp.where(do_evict, v_i, sv[rows, minpos]))
        return (sk, sv), None

    (slot_k, slot_v), _ = jax.lax.scan(
        step, (slot_k, slot_v), (keys.T, values.T)
    )
    return slot_k, slot_v


def bounded_slots_to_topk(
    slot_k: jax.Array, slot_v: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Extract descending top-k (values, keys) from accumulator slots."""
    masked = jnp.where(slot_k >= 0, slot_v, -jnp.inf)
    vals, pos = jax.lax.top_k(masked, k)
    keys = jnp.take_along_axis(slot_k, pos, axis=1)
    keys = jnp.where(jnp.isfinite(vals), keys, -1)
    vals = jnp.where(jnp.isfinite(vals), vals, 0.0)
    return vals, keys
