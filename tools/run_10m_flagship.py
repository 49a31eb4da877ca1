"""The 10M-vertex flagship at the reference's budget shape.

Reference: ``giraph/CombineBatchSingleWalkVertexReuse.java:39-48`` —
V=10,000,000, SAMPLE=10,000 walkers/source, STEP=5, path reuse TIMES=4
(2,500 physical walks of length 2·STEP+TIMES-1 feed 4 offset samples
each), query set stopV=100,000, source windows BATCH=40,000, 14 workers.

Device mapping: windows over the stopV query set; each window tile starts
``SAMPLE/TIMES`` walks per query source, builds the flat reuse item
stream (offset sources outside the tile are culled by the top-k
extraction — the stopV message cull,
``NormalCombineBatchSingleWalkVertexReuse.java:81-100``), normalises by
actual per-source sample counts (the flush normalisation,
``flushTest:79-94``), and reduces scatter-free with
``pair_topk_by_source``.  Durable window cursor + part files; interrupts
resume (``BatchSingleWalkVertex.java:108-133``).

Usage:
  python tools/run_10m_flagship.py [V] [avg_deg] [sample] [times] [stopV]
      [window] [tile] [budget_s]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import graphtpu
    from graphtpu.dist.windows import windowed_topk_sweep
    from graphtpu.kernels.topk import pair_topk_by_source, segment_sum_1d
    from graphtpu.native import native_generate_graph
    from graphtpu.simrank.uniwalk import _reuse_items
    from graphtpu.walks.walker import uniform_walks

    from graphtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    v = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    avg_deg = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    sample = int(sys.argv[3]) if len(sys.argv) > 3 else 10_000
    times = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    stop_v = int(sys.argv[5]) if len(sys.argv) > 5 else 100_000
    window = int(sys.argv[6]) if len(sys.argv) > 6 else 40_000
    tile = int(sys.argv[7]) if len(sys.argv) > 7 else 2048
    budget_s = float(sys.argv[8]) if len(sys.argv) > 8 else 1e9
    deadline = time.time() + budget_s
    step, topk, c = 5, 20, 0.6  # flagship constants (…Reuse.java:39-48)
    wpn = max(sample // times, 1)
    length = 2 * step + (times - 1)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(repo, "results"), exist_ok=True)
    path = os.path.join(repo, "results", f"g_{v}_{avg_deg}.txt")
    if not os.path.exists(path):
        t0 = time.time()
        n = native_generate_graph(
            path, "uniform", v, 0, target_edges=v * avg_deg // 2, seed=1
        )
        print(f"generated {n} edges in {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    g = graphtpu.load_graph_cached(path, n_nodes=v)
    print(
        f"graph: V={g.n_nodes} slots={g.n_edges} max_deg={g.max_degree} "
        f"load={time.time()-t0:.1f}s",
        flush=True,
    )

    hops_per_tile = tile * wpn * length
    stats = {"windows": 0, "tiles": 0, "wall": 0.0}

    class Budget(Exception):
        pass

    # the multi-GB CSR is a jit ARGUMENT: closure capture would embed it
    # as an HLO constant.  Four staged jits rather than one fused tile
    # keep each compile small.
    @jax.jit
    def walks_fn(gg, starts_rep, key):
        return uniform_walks(gg, starts_rep, length, key)

    @jax.jit
    def items_fn(deg, walks):
        return _reuse_items(deg, walks, step, c, times)

    @jax.jit
    def counts_fn(cnt_src):
        return segment_sum_1d(cnt_src, jnp.ones_like(cnt_src, jnp.float32), v)

    @jax.jit
    def topk_fn(srcs, tgts, vals, srcs_sorted, counts):
        return pair_topk_by_source(
            srcs, tgts, vals, srcs_sorted, topk, counts=counts
        )

    def reuse_tile(gg, starts_rep, srcs_sorted, key):
        walks = walks_fn(gg, starts_rep, key)
        srcs, tgts, vals, cnt_src = items_fn(gg.deg, walks)
        counts = counts_fn(cnt_src)
        return topk_fn(srcs, tgts, vals, srcs_sorted, counts)

    import faulthandler

    faulthandler.dump_traceback_later(300, repeat=True)

    def compute_tile(sources, key):
        if time.time() > deadline:
            raise Budget
        n = len(sources)
        out_v = np.zeros((n, topk), np.float32)
        out_i = np.zeros((n, topk), np.int32)
        t0 = time.time()
        for lo in range(0, n, tile):
            hi = min(lo + tile, n)
            chunk = sources[lo:hi]
            if len(chunk) < tile:
                # pad with the last source so the ascending order (and the
                # leading hi-lo real rows) survive
                chunk = np.concatenate(
                    [chunk, np.full(tile - len(chunk), chunk[-1], np.int32)]
                )
            starts = jnp.repeat(jnp.asarray(chunk), wpn)
            tt = time.time()
            vals, idx = reuse_tile(
                g, starts, jnp.asarray(chunk), jax.random.fold_in(key, lo)
            )
            print(f"    tile {lo}: {time.time()-tt:.1f}s", flush=True)
            # rows come back in sorted-source order; windows pass ascending
            # contiguous ranges so order == input order
            out_v[lo:hi] = np.asarray(vals)[: hi - lo]
            out_i[lo:hi] = np.asarray(idx)[: hi - lo]
            stats["tiles"] += 1
        stats["windows"] += 1
        stats["wall"] += time.time() - t0
        print(
            f"  window {stats['windows']}: {time.time()-t0:.1f}s "
            f"({hops_per_tile * (n // tile + (n % tile > 0)) / (time.time()-t0) / 1e6:.1f} M hops/s)",
            flush=True,
        )
        # durable per-window stats next to the parts: a killed run keeps
        # what it measured
        with open(os.path.join(out_dir, "stats.json"), "w") as f:
            json.dump(
                {
                    "V": v, "sample": sample, "times": times, "step": step,
                    "stopV": stop_v, "window": window, "tile": tile,
                    **stats,
                    "hops_per_s_session": round(
                        stats["tiles"] * hops_per_tile
                        / max(stats["wall"], 1e-9)
                    ),
                },
                f,
            )
        return out_v, out_i

    # run outputs live under results/ in the checkout (git-ignored)
    out_dir = os.path.join(repo, "results", f"flagship_{v}_{sample}")
    key = jax.random.key(13)

    t0 = time.time()
    try:
        windowed_topk_sweep(
            compute_tile, stop_v, out_dir, window=window, key=key
        )
        print(f"query sweep complete: {time.time()-t0:.1f}s", flush=True)
    except Budget:
        cursor = json.load(open(os.path.join(out_dir, "checkpoint.json")))
        print(f"budget expired cleanly; cursor={cursor}", flush=True)

    if stats["windows"] == 0:
        return
    hops = stats["tiles"] * hops_per_tile
    print(
        json.dumps(
            {
                "V": v,
                "slots": int(g.n_edges),
                "sample": sample,
                "times": times,
                "step": step,
                "stopV": stop_v,
                "window": window,
                "windows_done": stats["windows"],
                "total_hops": hops,
                "device_wall_s": round(stats["wall"], 1),
                "hops_per_s": round(hops / stats["wall"]),
                "per_window_s": round(stats["wall"] / stats["windows"], 1),
                "total_wall_s": round(time.time() - t0, 1),
            }
        ),
        flush=True,
    )
    parts = sorted(p for p in os.listdir(out_dir) if p.endswith(".sim.txt"))
    if parts:
        with open(os.path.join(out_dir, parts[0])) as f:
            print("part sample:", f.readline()[:120], flush=True)


if __name__ == "__main__":
    main()
