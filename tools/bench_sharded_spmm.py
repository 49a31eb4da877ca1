"""Scaling curve for the partitioned sparse SimRank.

Runs ``sharded_simrank_spmm`` on virtual CPU meshes of 1/2/4/8 devices
over the same graph and reports per-iteration wall time and strong-
scaling efficiency.  This is the hardware-permitting proxy for the
BASELINE "≥90% scaling at 2 hosts" target: the virtual devices share one
host's cores, so compute barely scales, but the numbers expose the
COMMUNICATION overhead of the ring rotation (time(n)/time(1) - 1 at
fixed total work) and any serialisation bugs.  On real multi-chip
hardware the same program rides the device interconnect.

Usage: python tools/bench_sharded_spmm.py [V] [E] [iters]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEV = 8
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={N_DEV}"
).strip()

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    import graphtpu
    from graphtpu.core.config import SimRankConfig
    from graphtpu.dist.mesh import make_1d_mesh
    from graphtpu.dist.spmm_sharded import sharded_simrank_spmm

    v = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    e = int(sys.argv[2]) if len(sys.argv) > 2 else 16 * 4096
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 3

    rng = np.random.default_rng(0)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)
    g = graphtpu.build_graph(np.concatenate([edges, ring]), n_nodes=v)
    print(f"V={g.n_nodes} slots={g.n_edges}", flush=True)

    cfg = SimRankConfig(iterations=iters)
    base = None
    results = {}
    for n in (1, 2, 4, 8):
        mesh = make_1d_mesh(n)
        t0 = time.time()
        s = sharded_simrank_spmm(g, mesh, cfg)
        s.block_until_ready()
        compile_and_run = time.time() - t0
        t0 = time.time()
        s = sharded_simrank_spmm(g, mesh, cfg)
        s.block_until_ready()
        warm = (time.time() - t0) / iters
        del s
        results[n] = warm
        if base is None:
            base = warm
        eff = base / (warm * 1)  # strong scaling on shared cores: t1/tn
        print(
            f"n_dev={n}: {warm*1e3:.1f} ms/iter "
            f"(first {compile_and_run:.1f}s incl. plan+compile), "
            f"t1/tn={eff:.2f}",
            flush=True,
        )
    import json

    print(json.dumps({"per_iter_ms": {k: round(1e3 * t, 1) for k, t in results.items()}}))


if __name__ == "__main__":
    main()
