"""Reference QA protocol for real: precision@20 + NDCG@20 vs 30-iteration
gold, per engine, on the reference's own datasets.

Protocol match per engine (each with its ACTIVE reference grid):
  uniwalk / topsim_singleSample — {1000..40000}
    (``benchmark/Test_u_u_TopSim_singleSample.java:25-64``)
  doubleRandomWalk — {5,10,50,100,200,400}, step 1
    (``Test_u_u_doubleRandomWalk_Sample.java:32-43``)
  topsim_doubleSample — {5,10,50}, step 1
    (``Test_u_u_TopSim_doubleSample.java:38-40``)
  topsim_dev — {10000}, step 3 (``Test_u_u_TopSim_Dev.java:38-40``)
Scoring: ``utils/Eval.java:81-140`` (realK+MIN precision), ``:257-291``
(NDCG).  Deviation from the reference: scores are estimated over a fixed
random subset of sources (default 2048, SE ~2%) instead of every vertex;
``n_sources >= V`` runs the full-V sweep (the estimator-validation mode).

Usage: python tools/run_sweeps.py [n_sources] [out.jsonl] [dataset ...]

Resumable: (dataset, algorithm, sample) records already present in
``out.jsonl`` are skipped, so an interrupted sweep continues where it
left off (the windowed-job pattern, ``BatchSingleWalkVertex.java:108-133``).
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (path, n_nodes (None = infer), gold impl, V for source-count clamping)
DATASETS = {
    "moreno_crime": (
        "/root/reference/DeepSim/lshrank_data/realdata/moreno_crime_crime.txt",
        None,
        "dense",
        1380,
    ),
    "blog": (
        "/root/reference/DeepSim/lshrank_data/realdata/blog.txt",
        10496,
        "dense",
        10496,
    ),
    "arxiv": (
        "/root/reference/DeepSim/lshrank_data/realdata/arxiv_author_pub.txt",
        38912,
        "spmm",
        38912,
    ),
}

# engines swept per dataset: the V^2-state engines (doublewalk /
# doublesample rows, dev's dense phase 2) run on the dense-range
# datasets, like the reference's single-JVM drivers
ENGINES_SMALL = (
    "uniwalk", "topsim_singleSample", "doubleRandomWalk",
    "topsim_doubleSample", "topsim_dev",
)
ENGINES_LARGE = ("uniwalk", "topsim_singleSample")


def main():
    import jax

    import graphtpu
    from graphtpu.bench.sweep import (
        DEV_SAMPLE_GRID,
        DOUBLESAMPLE_GRID,
        DOUBLEWALK_SAMPLE_GRID,
        REFERENCE_SAMPLE_GRID,
        gold_standard,
        sweep_doublesample,
        sweep_doublewalk,
        sweep_topsim,
        sweep_topsim_dev,
        sweep_uniwalk,
    )
    from graphtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    specs = {
        "uniwalk": (sweep_uniwalk, REFERENCE_SAMPLE_GRID),
        "topsim_singleSample": (sweep_topsim, REFERENCE_SAMPLE_GRID),
        "doubleRandomWalk": (sweep_doublewalk, DOUBLEWALK_SAMPLE_GRID),
        "topsim_doubleSample": (sweep_doublesample, DOUBLESAMPLE_GRID),
        "topsim_dev": (sweep_topsim_dev, DEV_SAMPLE_GRID),
    }

    n_src = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    # optional narrowing for targeted runs (e.g. the full-V estimator
    # validation): GRAPHTPU_SWEEP_ALGS="uniwalk,topsim_singleSample"
    # GRAPHTPU_SWEEP_SAMPLES="10000"
    only_algs = set(
        a for a in os.environ.get("GRAPHTPU_SWEEP_ALGS", "").split(",") if a
    )
    only_samples = set(
        float(s)
        for s in os.environ.get("GRAPHTPU_SWEEP_SAMPLES", "").split(",")
        if s
    )
    out_path = (
        sys.argv[2]
        if len(sys.argv) > 2
        else os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "results", "sweeps.jsonl")
    )
    want = set(sys.argv[3:]) or set(DATASETS)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["dataset"], r["algorithm"],
                              float(r["sample"]), r.get("n_sources")))
                except Exception:
                    pass
    out = open(out_path, "a")

    for name, (path, n_nodes, gold_impl, v_hint) in DATASETS.items():
        if name not in want:
            continue
        engines = ENGINES_SMALL if gold_impl == "dense" else ENGINES_LARGE
        if only_algs:
            engines = tuple(a for a in engines if a in only_algs)
        # Load the graph BEFORE the resume precheck so both it and the
        # authoritative per-point check key on the same min(n_src,
        # g.n_nodes) — a node-count hint could drift from the true node
        # count and skip a dataset with remaining points.  Graph loads are host-side and cheap next
        # to a single grid point.
        g = graphtpu.read_edgelist_graph(path, n_nodes=n_nodes)
        del v_hint
        need = [
            (alg, s)
            for alg in engines
            for s in specs[alg][1]
            if (name, alg, float(s), min(n_src, g.n_nodes)) not in done
            and (not only_samples or float(s) in only_samples)
        ]
        if not need:
            print(f"{name}: complete, skipping", flush=True)
            continue
        rng = np.random.default_rng(0)
        full_v = n_src >= g.n_nodes
        ns = min(n_src, g.n_nodes)
        sources = (
            np.arange(g.n_nodes, dtype=np.int32)
            if full_v
            else np.sort(
                rng.choice(g.n_nodes, size=ns, replace=False)
            ).astype(np.int32)
        )
        t0 = time.time()
        gold = gold_standard(g, sources=sources, impl=gold_impl)
        print(
            f"{name}: V={g.n_nodes} slots={g.n_edges} gold({gold_impl}) "
            f"{time.time()-t0:.1f}s, {ns} sources"
            + (" (FULL V)" if full_v else ""),
            flush=True,
        )
        for alg in engines:
            fn, grid = specs[alg]
            for s in grid:
                if (name, alg, float(s), int(ns)) in done:
                    print(f"{name}/{alg}/{s}: done, skipping", flush=True)
                    continue
                if only_samples and float(s) not in only_samples:
                    continue
                try:
                    results = fn(
                        g, gold, samples=[s],
                        key=jax.random.key(11), sources=sources,
                    )
                except Exception as e:  # pragma: no cover - env failures
                    # one failing grid point must not kill the sweep —
                    # log and keep going; the resume key retries it on
                    # the next invocation (a remote-compile EOF killed a
                    # whole round-4 batch attempt at one point)
                    print(f"{name}/{alg}/{s}: FAILED {e!r}", flush=True)
                    continue
                for r in results:
                    rec = {"dataset": name, "n_sources": int(ns),
                           **dataclasses.asdict(r)}
                    print(json.dumps(rec), flush=True)
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    out.close()


if __name__ == "__main__":
    main()
