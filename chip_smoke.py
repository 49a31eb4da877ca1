#!/usr/bin/env python
"""Smoke test of graphtpu's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]     # one card: every phase below
    python chip_smoke.py --multi        # four cards: the sharded paths only

One card, through the user entry points (``graphtpu.cli.main``, the code
behind ``python -m graphtpu``), every graph an R-MAT (Graph500
parameters) generated from ``--seed`` and written as an edge list first:

  * node2vec at BlogCatalog's edge count (scale 14, 333,983 edges) with
    the reference defaults and p = q = 0.25, one SGNS epoch; checks the
    ``.emb``, that every hop of a walk sample is an edge, and the
    second-order transition frequencies against the exact bias rule;
  * exact SimRank at blog's size (V=10,313, E=333,983), dense and SpMM
    engines through the CLI, then the same library calls compared;
  * SpMM SimRank at arxiv's size (V=38,741, 668k CSR slots) against
    dense, with the gather tree's bytes/s beside a large copy's;
  * both engines against a float64 host reference on 2,048 nodes.

``--multi`` runs the 1-D ring, 2-D SUMMA and dense sharded SimRank, the
distributed node2vec walker and the mesh-sharded SGNS trainer over four
cards, each compared with its single-card form on device 0.

Every check that fails ends the run with a non-zero exit.  The last line
of a passing run is one JSON object naming the device.  Without a GPU
the script exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

BLOG_V, BLOG_E = 10_313, 333_983
ARXIV_V, ARXIV_E = 38_741, 334_000  # 668k CSR slots
N2V_SCALE = 14
EXACT_V, EXACT_E = 2_048, 16_384
SIMRANK_C, SIMRANK_ITERS, TOPK = 0.6, 3, 20
TOL_SPARSE = 2e-5   # two f32 engines summed in different orders
TOL_GOLD = 1e-6     # dense at "highest" vs the float64 reference
TOL_SGNS = 1e-5     # mesh-sharded vs single-card SGNS trajectory
TOL_TV = 0.06       # second-order transition total variation


class CheckFailed(AssertionError):
    pass


def log(*a):
    print(*a, flush=True)


def check(name: str, value, bound, ok: bool | None = None):
    """Print one check; raise if it fails."""
    if ok is None:
        ok = bool(value <= bound)
    log(f"check {name}: value={value} bound={bound} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed(f"{name}: {value} (bound {bound})")


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


@contextlib.contextmanager
def phase(name: str):
    """Wall time, process peak device bytes and parser in use for a phase."""
    from graphtpu.native import native_available

    log(f"phase {name}: start")
    t0 = time.perf_counter()
    yield
    log(
        f"phase {name}: done wall_s={time.perf_counter() - t0:.3f} "
        f"peak_bytes_in_use={peak_bytes()} "
        f"edgelist_parser={'native' if native_available() else 'numpy'}"
    )


def rmat(n_nodes: int, n_edges: int, seed: int):
    """A generated graph, built in memory."""
    import graphtpu
    from graphtpu.bench.generators import rmat_unique_edges

    edges = rmat_unique_edges(n_nodes, n_edges, seed=seed)
    return graphtpu.build_graph(edges, n_nodes=n_nodes)


def write_rmat(path: str, n_nodes: int, n_edges: int, seed: int) -> None:
    """A generated graph, written as an edge list for the CLI."""
    from graphtpu.bench.generators import rmat_unique_edges

    np.savetxt(path, rmat_unique_edges(n_nodes, n_edges, seed=seed), fmt="%d")


def hops_are_edges(g, walks: np.ndarray) -> tuple[int, int]:
    """(hops checked, hops that are not edges) over a walk tensor."""
    from graphtpu.core.graph import host_csr

    row_ptr, col, _, _ = host_csr(g)
    row_ptr, col = np.asarray(row_ptr, np.int64), np.asarray(col, np.int64)
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(row_ptr))
    keys = np.sort(src * g.n_nodes + col)
    u, v = walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1)
    live = v >= 0
    q = u[live].astype(np.int64) * g.n_nodes + v[live]
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return int(live.sum()), int((keys[pos] != q).sum())


def max_abs_diff(a, b) -> float:
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                 - jnp.asarray(b, jnp.float32))))


# ----------------------------------------------------------------- phases


def phase_node2vec(
    workdir: str,
    scale: int = N2V_SCALE,
    n_edges: int = BLOG_E,
    seed: int = 0,
    dim: int = 128,
    walk_length: int = 80,
    num_walks: int = 10,
    window: int = 10,
    p: float = 0.25,
    q: float = 0.25,
    epochs: int = 1,
    walk_sample: int = 2000,
    tv_samples: int = 200_000,
) -> dict:
    """node2vec through the CLI, then the walk checks on the same walks."""
    import jax
    import jax.numpy as jnp

    import graphtpu
    from graphtpu.cli import main as cli_main
    from graphtpu.core.config import SGNSConfig, WalkConfig
    from graphtpu.io.embfile import read_emb
    from graphtpu.kernels.edgeset import device_edge_set
    from graphtpu.walks.node2vec import (
        _second_order_step_rejection,
        default_max_trials,
        node2vec_transition_probs,
    )
    from graphtpu.walks.walker import simulate_walks

    path = os.path.join(workdir, "rmat.edgelist")
    emb = os.path.join(workdir, "rmat.emb")
    write_rmat(path, 1 << scale, n_edges, seed)
    t0 = time.perf_counter()
    rc = cli_main([
        "node2vec", "--input", path, "--output", emb,
        "--dimensions", str(dim), "--walk-length", str(walk_length),
        "--num-walks", str(num_walks), "--window-size", str(window),
        "--p", str(p), "--q", str(q), "--iter", str(epochs),
        "--seed", str(seed),
    ])
    cli_s = time.perf_counter() - t0
    check("node2vec cli exit code", rc, 0, ok=rc == 0)

    g = graphtpu.read_edgelist_graph(path)
    deg = np.asarray(g.deg)
    active = int((deg > 0).sum())
    labels, vecs = read_emb(emb)
    log(f"node2vec: V={g.n_nodes} slots={g.n_edges} active={active} "
        f"cli_wall_s={cli_s:.3f}")
    check("emb rows == non-isolated nodes", len(labels), active,
          ok=len(labels) == active)
    check("emb width", vecs.shape[1], dim, ok=vecs.shape[1] == dim)
    check("emb finite", bool(np.isfinite(vecs).all()), True,
          ok=bool(np.isfinite(vecs).all()))

    # the pipeline's walks, rebuilt from the same seed (node2vec_pipeline)
    wcfg = WalkConfig(num_walks=num_walks, walk_length=walk_length, p=p, q=q)
    k_walk, _ = jax.random.split(jax.random.key(seed))
    walks = simulate_walks(
        g, num_walks=wcfg.num_walks, walk_length=wcfg.walk_length, key=k_walk,
        p=wcfg.p, q=wcfg.q, second_order_mode=wcfg.second_order_mode,
        max_trials=wcfg.max_rejection_trials,
    )
    walks = np.asarray(walks)
    slots = walks.size
    batch = min(SGNSConfig().batch_size, slots, max(64, g.n_nodes))
    log(f"node2vec: walks={walks.shape} sgns_steps={epochs * (slots // batch)} "
        f"batch={batch}")
    rows = np.random.default_rng(seed).choice(
        walks.shape[0], size=min(walk_sample, walks.shape[0]), replace=False
    )
    n_hops, bad = hops_are_edges(g, walks[rows])
    check(f"walk hops that are not edges (of {n_hops})", bad, 0)

    # second-order transition frequencies at one (prev, cur) pair: cur of
    # moderate degree, prev its highest-degree neighbour (most triangles)
    row_ptr, col = np.asarray(g.row_ptr), np.asarray(g.col)
    cur = int(np.argmin(np.abs(deg - 64) + (deg == 0) * 10**9))
    nbrs = col[row_ptr[cur]:row_ptr[cur + 1]]
    prev = int(nbrs[np.argmax(deg[nbrs])])
    es = device_edge_set(g)
    step = jax.jit(
        lambda g_, es_, pa, ca, k: _second_order_step_rejection(
            g_, None, es_, pa, ca, k, 1.0 / p, 1.0 / q,
            default_max_trials(p, q), False,
        )
    )
    nxt = np.asarray(step(
        g, es, jnp.full((tv_samples,), prev, jnp.int32),
        jnp.full((tv_samples,), cur, jnp.int32), jax.random.key(seed + 7),
    ))
    check("second-order samples alive", int((nxt < 0).sum()), 0)
    emp = np.bincount(nxt, minlength=g.n_nodes) / tv_samples
    want = node2vec_transition_probs(g, prev, cur, p, q)
    tv = float(0.5 * np.abs(emp - want).sum())
    check(f"second-order TV (prev={prev} cur={cur} deg={deg[cur]})", tv, TOL_TV)
    return {"cli_wall_s": cli_s, "tv": tv}


def time_spmm_iteration(plan, n_nodes: int, reps: int = 3) -> float:
    """Warm seconds per ``exact_simrank_spmm`` iteration on ``plan``."""
    import jax.numpy as jnp

    from graphtpu.simrank.exact import _spmm_init, _spmm_iterate

    diag = jnp.arange(n_nodes, dtype=jnp.int32)
    s = _spmm_init(diag, jnp.float32)
    s = _spmm_iterate(plan, s, diag, SIMRANK_C, 4096, jnp.float32)
    s.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        s = _spmm_iterate(plan, s, diag, SIMRANK_C, 4096, jnp.float32)
    s.block_until_ready()
    return (time.perf_counter() - t0) / reps


def time_products(g, reps: int = 3) -> dict:
    """Per-iteration time and effective bytes/s of the engine's product
    and, beside it, of the XLA gather tree."""
    from graphtpu.kernels.spmm import build_reduction_tree
    from graphtpu.simrank.exact import build_spmm_plan

    out = {}
    for name, plan in (("engine", build_spmm_plan(g)),
                       ("tree", build_reduction_tree(g))):
        per = time_spmm_iteration(plan, g.n_nodes, reps)
        rate = spmm_bytes_per_iter(g) / per
        log(f"spmm {name} ({type(plan).__name__}): V={g.n_nodes} "
            f"s_per_iter={per} bytes_per_s={rate}")
        out[name] = rate
    return out


def spmm_bytes_per_iter(g) -> float:
    """Two products per iteration, each (slots + V) row reads of V f32."""
    return 2.0 * (g.n_edges + g.n_nodes) * g.n_nodes * 4


def phase_simrank_cli(
    workdir: str,
    n_nodes: int = BLOG_V,
    n_edges: int = BLOG_E,
    seed: int = 0,
    time_reps: int = 3,
) -> dict:
    """Both SimRank engines through the CLI, then the library comparison."""
    import graphtpu
    from graphtpu.cli import main as cli_main
    from graphtpu.core.config import SimRankConfig
    from graphtpu.simrank.exact import exact_simrank, exact_simrank_spmm

    path = os.path.join(workdir, "blog.edgelist")
    write_rmat(path, n_nodes, n_edges, seed + 1)
    for engine in ("dense", "spmm"):
        out = os.path.join(workdir, f"blog.{engine}")
        t0 = time.perf_counter()
        rc = cli_main([
            "simrank", "--input", path, "--output", out,
            "--engine", engine, "--c", str(SIMRANK_C),
            "--iterations", str(SIMRANK_ITERS), "--topk", str(TOPK),
        ])
        log(f"simrank cli --engine {engine}: "
            f"wall_s={time.perf_counter() - t0:.3f}")
        check(f"simrank --engine {engine} exit code", rc, 0, ok=rc == 0)
        ok = os.path.getsize(out + ".sim.txt") > 0
        check(f"simrank --engine {engine} wrote .sim.txt", ok, True, ok=ok)

    g = graphtpu.read_edgelist_graph(path, n_nodes=n_nodes)
    cfg = SimRankConfig(c=SIMRANK_C, iterations=SIMRANK_ITERS)
    dense = exact_simrank(g, cfg, matmul_precision="highest")
    sparse = exact_simrank_spmm(g, cfg)
    log(f"simrank: V={g.n_nodes} slots={g.n_edges}")
    check("dense vs spmm max|d|", max_abs_diff(dense, sparse), TOL_SPARSE)
    del dense, sparse
    return time_products(g, time_reps)


def phase_spmm_large(
    n_nodes: int = ARXIV_V,
    n_edges: int = ARXIV_E,
    seed: int = 0,
    time_reps: int = 3,
) -> dict:
    """The sparse engine at a size whose f32 iterates are 6 GB each."""
    import graphtpu
    from graphtpu.core.config import SimRankConfig
    from graphtpu.simrank.exact import exact_simrank, exact_simrank_spmm

    g = rmat(n_nodes, n_edges, seed + 2)
    cfg = SimRankConfig(c=SIMRANK_C, iterations=SIMRANK_ITERS)
    log(f"spmm large: V={g.n_nodes} slots={g.n_edges} "
        f"iterate_bytes={4 * g.n_nodes ** 2}")
    sparse = exact_simrank_spmm(g, cfg)
    sparse.block_until_ready()
    log(f"spmm large: sparse done peak_bytes_in_use={peak_bytes()}")
    dense = exact_simrank(g, cfg, matmul_precision="highest")
    check("large dense vs spmm max|d|", max_abs_diff(dense, sparse),
          TOL_SPARSE)
    del dense, sparse
    return time_products(g, time_reps)


def simrank_reference_f64(g, c: float, iterations: int) -> np.ndarray:
    """S = C·W·S·Wᵀ in float64 on the host, diagonal pinned, then zeroed."""
    from graphtpu.core.graph import host_csr

    row_ptr, col, _, _ = host_csr(g)
    v = g.n_nodes
    a = np.zeros((v, v))
    src = np.repeat(np.arange(v), np.diff(np.asarray(row_ptr)))
    np.add.at(a, (src, np.asarray(col)), 1.0)
    rs = a.sum(axis=1, keepdims=True)
    w = np.where(rs > 0, a / np.where(rs > 0, rs, 1.0), 0.0)
    s = np.eye(v)
    for _ in range(iterations):
        s = c * (w @ s @ w.T)
        np.fill_diagonal(s, 1.0)
    np.fill_diagonal(s, 0.0)
    return s


def phase_exactness(
    n_nodes: int = EXACT_V, n_edges: int = EXACT_E, seed: int = 0
) -> dict:
    """Dense and sparse engines against the float64 host reference."""
    import graphtpu
    from graphtpu.core.config import SimRankConfig
    from graphtpu.simrank.exact import exact_simrank, exact_simrank_spmm

    g = rmat(n_nodes, n_edges, seed + 3)
    cfg = SimRankConfig(c=SIMRANK_C, iterations=SIMRANK_ITERS)
    ref = simrank_reference_f64(g, cfg.c, cfg.iterations)
    hi = np.asarray(exact_simrank(g, cfg, matmul_precision="highest"))
    sp = np.asarray(exact_simrank_spmm(g, cfg))
    lo = np.asarray(exact_simrank(g, cfg, matmul_precision="default"))
    check("dense highest vs float64", float(np.abs(hi - ref).max()), TOL_GOLD)
    check("spmm vs float64", float(np.abs(sp - ref).max()), TOL_SPARSE)
    err_default = float(np.abs(lo - ref).max())
    log(f"dense default-precision vs float64 max|d|={err_default} "
        "(reported, not checked)")
    return {"dense_default_err": err_default}


def phase_copy_rate(n_bytes: int = 4 << 30, reps: int = 10) -> float:
    """Bytes/s of a large read-one-write-one pass on the device."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    f(x).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    rate = 2.0 * n_bytes / float(np.median(times))
    log(f"copy: bytes={n_bytes} median_s={np.median(times)} bytes_per_s={rate}")
    return rate


def phase_multi(
    n_nodes: int = BLOG_V,
    n_edges: int = BLOG_E,
    seed: int = 0,
    n_dev: int = 4,
    sgns_dim: int = 128,
    sgns_epochs: int = 3,
    n2v_walkers: int = 32_768,
    n2v_steps: int = 20,
) -> dict:
    """Sharded paths on ``n_dev`` devices against single-card runs."""
    import jax

    from graphtpu.core.config import SGNSConfig, SimRankConfig
    from graphtpu.dist.mesh import make_1d_mesh, make_mesh
    from graphtpu.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu.dist.sharded_graph import shard_graph
    from graphtpu.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu.dist.spmm_sharded import sharded_simrank_spmm
    from graphtpu.dist.spmm_summa import make_2d_mesh, summa_simrank_spmm
    from graphtpu.models.sgns import train_sgns
    from graphtpu.simrank.exact import exact_simrank_spmm
    from graphtpu.walks.walker import simulate_walks

    n_have = len(jax.devices())
    check("devices for --multi", n_have, n_dev, ok=n_have >= n_dev)
    g = rmat(n_nodes, n_edges, seed + 1)
    cfg = SimRankConfig(c=SIMRANK_C, iterations=SIMRANK_ITERS)
    log(f"multi: V={g.n_nodes} slots={g.n_edges} devices={n_dev}")
    want = np.asarray(exact_simrank_spmm(g, cfg))  # device 0
    mesh1 = make_1d_mesh(n_dev)
    r = int(np.sqrt(n_dev))
    runs = {
        "ring spmm": lambda: sharded_simrank_spmm(g, mesh1, cfg),
        "summa spmm": lambda: summa_simrank_spmm(
            g, make_2d_mesh(r, n_dev // r), cfg),
        "sharded dense": lambda: sharded_exact_simrank(g, mesh1, cfg),
    }
    out = {}
    for name, run in runs.items():
        log(f"multi {name}: start")
        t0 = time.perf_counter()
        got = run()
        got.block_until_ready()
        spread = len(got.sharding.device_set)
        log(f"multi {name}: wall_s={time.perf_counter() - t0:.3f} "
            f"devices_holding_result={spread}")
        check(f"{name} devices holding result", spread, n_dev,
              ok=spread == n_dev)
        err = float(np.abs(np.asarray(got) - want).max())
        check(f"{name} vs single-card spmm max|d|", err, TOL_SPARSE)
        out[name] = err
    del want

    log("multi distributed walks: start")
    sg = shard_graph(g, n_dev, mesh=mesh1)
    dw = distributed_node2vec_walks(
        sg, n2v_walkers, n2v_steps, 0.25, 0.25, jax.random.key(seed + 5),
        mesh1,
    )
    spread = len(dw.sharding.device_set)
    check("distributed walks devices holding result", spread, n_dev,
          ok=spread == n_dev)
    n_hops, bad = hops_are_edges(g, np.asarray(dw))
    check(f"distributed walk hops that are not edges (of {n_hops})", bad, 0)

    log("multi sgns: start")
    walks = simulate_walks(g, 1, 80, jax.random.key(seed))
    scfg = SGNSConfig(dim=sgns_dim, epochs=sgns_epochs, seed=seed)
    s0, s1 = train_sgns(walks, g.n_nodes, scfg)
    log("multi sgns: single-card run done")
    t0 = time.perf_counter()
    d0, d1 = train_sgns(walks, g.n_nodes, scfg,
                        mesh=make_mesh(n_dev, model_parallel=2))
    log(f"multi sgns: walks={walks.shape} "
        f"wall_s={time.perf_counter() - t0:.3f}")
    err = float(max(np.abs(d0 - s0).max(), np.abs(d1 - s1).max()))
    check("sharded sgns vs single-card max|d|", err, TOL_SGNS)
    out["sgns"] = err
    return out


# ------------------------------------------------------------------- main


def gpu_line() -> str:
    """The card's name and power limit, read off JAX by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def build_native() -> None:
    r = subprocess.run(
        ["make", "-C", os.path.join(REPO, "graphtpu", "native")],
        capture_output=True, text=True, timeout=300,
    )
    if r.returncode == 0:
        log("native edge-list parser: built")
    else:
        log(f"native edge-list parser: not built (make exit {r.returncode}: "
            f"{(r.stderr or r.stdout).strip()[-300:]}); numpy parser in use")


def run_single(seed: int) -> None:
    with tempfile.TemporaryDirectory(prefix="graphtpu_smoke_") as wd:
        with phase("node2vec"):
            phase_node2vec(wd, seed=seed)
        with phase("simrank blog cli"):
            blog = phase_simrank_cli(wd, seed=seed)
    with phase("simrank arxiv spmm"):
        arxiv = phase_spmm_large(seed=seed)
    with phase("simrank exactness"):
        phase_exactness(seed=seed)
    with phase("copy rate"):
        copy = phase_copy_rate()
    for size, rates in (("blog", blog), ("arxiv", arxiv)):
        for name, rate in rates.items():
            log(f"spmm {name} {size}: bytes_per_s={rate} "
                f"copy_bytes_per_s={copy} share_of_copy={rate / copy}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths and their "
                         "single-card comparisons only")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from graphtpu.utils.compile_cache import enable_compile_cache

    log(gpu_line())
    log(f"jax {jax.__version__} device_kind={dev.device_kind} "
        f"devices={len(jax.devices())} compile_cache={enable_compile_cache()}")
    build_native()
    t0 = time.perf_counter()
    if args.multi:
        with phase("multi"):
            phase_multi(seed=args.seed)
    else:
        run_single(args.seed)
    log(f"total wall_s={time.perf_counter() - t0:.3f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
