"""Profile one SGNS step on the device and print the top ops by duration.

Writes a jax.profiler trace, then parses the perfetto trace proto/json to
rank XLA ops — usable without TensorBoard.
"""

import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main(logdir="/tmp/jaxprof"):
    from graphtpu.models.sgns import (
        _gather_batch,
        alias_draw_batch,
        build_negative_alias,
        corpus_counts,
        sgns_manual_grads,
    )

    V, D, B, W, N = 10313, 128, 8192, 10, 5
    walks = jnp.asarray(np.load("/tmp/blog_walks.npy"))
    counts = corpus_counts(walks, V)
    neg_j, neg_q = build_negative_alias(counts)
    rng = np.random.default_rng(0)
    params = (
        jnp.asarray(rng.normal(scale=0.01, size=(V, D)).astype(np.float32)),
        jnp.asarray(rng.normal(scale=0.01, size=(V, D)).astype(np.float32)),
    )

    @jax.jit
    def one_step(params, k):
        k_s, k_win, k_neg = jax.random.split(k, 3)
        slots = jax.random.randint(k_s, (B,), 0, walks.size)
        centers, contexts, mask = _gather_batch(walks, slots, W, k_win)
        negs = alias_draw_batch(neg_j, neg_q, k_neg, (B, N))
        (g0, g1), (c0, c1) = sgns_manual_grads(
            params, centers, contexts, mask, negs, V
        )
        syn0, syn1 = params
        return (
            syn0 - 0.01 * g0 / jnp.maximum(c0, 1)[:, None],
            syn1 - 0.01 * g1 / jnp.maximum(c1, 1)[:, None],
        )

    params = one_step(params, jax.random.key(0))
    jax.block_until_ready(params)
    t0 = time.time()
    for i in range(10):
        params = one_step(params, jax.random.key(i))
    jax.block_until_ready(params)
    print(f"per step: {(time.time() - t0) / 10 * 1000:.0f} ms", flush=True)

    jax.profiler.start_trace(logdir)
    for i in range(3):
        params = one_step(params, jax.random.key(100 + i))
    jax.block_until_ready(params)
    jax.profiler.stop_trace()

    # parse the perfetto json.gz trace
    files = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace found under", logdir)
        return
    path = max(files, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    durs = defaultdict(float)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")
            durs[name] += ev["dur"]
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:30]
    total = sum(durs.values())
    print(f"trace: {path}\ntotal event-us: {total:.0f}")
    for name, d in top:
        print(f"{d/1000:10.2f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
