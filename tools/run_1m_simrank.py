"""1M-vertex windowed MC SimRank end-to-end on one device.

Matches the reference's distributed regime structure: generate a large
graph (GraphGeneratorBf's role -> native/generate.cpp), run UniWalk MC
SimRank over batched source windows with streamed top-k flush and a
durable cursor (``giraph/BatchSingleWalkVertex_Byte.java:38-41``: V=1M,
SAMPLE walks, batched windows; flush + voteToHalt per window).  The run
deliberately interrupts itself after a few windows and RESUMES from the
checkpoint to demonstrate the fault-tolerance path at scale.

Usage: python tools/run_1m_simrank.py [V] [avg_deg] [sample] [window] [budget_s]

``budget_s`` stops CLEANLY between windows (the durable cursor resumes
next invocation), so a run can be cut without losing finished windows.
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
    from graphtpu.core.config import UniWalkConfig
    from graphtpu.dist.windows import windowed_topk_sweep
    from graphtpu.native import native_generate_graph
    from graphtpu.simrank.uniwalk import _uniwalk_tile_topk
    from graphtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    v = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    avg_deg = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    sample = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    window = int(sys.argv[4]) if len(sys.argv) > 4 else 40960
    budget_s = float(sys.argv[5]) if len(sys.argv) > 5 else 1e9
    deadline = time.time() + budget_s
    step, topk, tile = 3, 20, 8192

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

    cfg = UniWalkConfig(sample=sample, step=step, topk=topk, source_tile=tile)
    kw = dict(sample=sample, step=step, c=cfg.c, topk=topk, tile=tile)
    hops_per_tile = tile * sample * 2 * step
    stats = {"windows": 0, "tiles": 0, "wall": 0.0}

    class Budget(Exception):
        pass

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
                chunk = np.concatenate(
                    [chunk, np.zeros(tile - len(chunk), np.int32)]
                )
            vals, idx = _uniwalk_tile_topk(
                g, jnp.asarray(chunk), jax.random.fold_in(key, lo), **kw
            )
            out_v[lo:hi] = np.asarray(vals)[: hi - lo]
            out_i[lo:hi] = np.asarray(idx)[: hi - lo]
            stats["tiles"] += 1
        stats["windows"] += 1
        stats["wall"] += time.time() - t0
        return out_v, out_i

    out_dir = os.path.join(repo, "results", f"sweep_{v}")
    key = jax.random.key(7)

    # phase 1: first few windows, then stop (simulated failure)
    t0 = time.time()
    try:
        windowed_topk_sweep(
            compute_tile, min(3 * window, v), out_dir, window=window, key=key
        )
    except Budget:
        pass
    cursor = json.load(open(os.path.join(out_dir, "checkpoint.json")))
    print(
        f"phase1: 3 windows in {time.time()-t0:.1f}s "
        f"(incl. compile); cursor={cursor}",
        flush=True,
    )

    # phase 2: resume from the durable cursor and finish all V sources
    t0 = time.time()
    try:
        windowed_topk_sweep(compute_tile, v, out_dir, window=window, key=key)
        print(f"phase2(resume -> full V): {time.time()-t0:.1f}s", flush=True)
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
                "step": step,
                "windows": stats["windows"],
                "total_hops": hops,
                "device_wall_s": round(stats["wall"], 1),
                "hops_per_s": round(hops / stats["wall"]),
                "per_window_ms": round(stats["wall"] / stats["windows"] * 1e3),
            }
        ),
        flush=True,
    )
    # spot-check one part file
    part = sorted(
        p for p in os.listdir(out_dir) if p.endswith(".sim.txt")
    )[0]
    with open(os.path.join(out_dir, part)) as f:
        print("part sample:", f.readline()[:120], flush=True)


if __name__ == "__main__":
    main()
