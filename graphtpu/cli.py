"""Command-line interface — the reference argparse entry points unified.

``python -m graphtpu node2vec ...`` mirrors ``node2vec/src/main.py:20-73``
(same flags and defaults, including --p/--q and the weighted/directed
toggles); ``simrank`` / ``uniwalk`` / ``topsim`` expose the Java engines;
``deepsim`` mirrors ``DeepSim/src/main.py:18-80``; ``sweep`` runs the
``Test_u_u_*`` gold-standard protocol.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="graphtpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    n2v = sub.add_parser("node2vec", help="node2vec walks + SGNS -> .emb")
    n2v.add_argument("--input", required=True)
    n2v.add_argument("--output", required=True)
    n2v.add_argument("--dimensions", type=int, default=128)
    n2v.add_argument("--walk-length", type=int, default=80)
    n2v.add_argument("--num-walks", type=int, default=10)
    n2v.add_argument("--window-size", type=int, default=10)
    n2v.add_argument("--iter", type=int, default=10)
    n2v.add_argument("--p", type=float, default=1.0)
    n2v.add_argument("--q", type=float, default=1.0)
    n2v.add_argument("--weighted", action="store_true")
    n2v.add_argument("--directed", action="store_true")
    n2v.add_argument("--delimiter", default=None)
    n2v.add_argument("--seed", type=int, default=0)
    n2v.add_argument("--subsample", type=float, default=1e-3)
    # the reference __main__ sweeps the FULL p x q cross product
    # (node2vec/src/main.py:117-124: ps = qs = [0.25,0.5,1,2,4], nested
    # loops), writing one .emb per setting; --grid "0.25,0.5,1,2,4" does
    # the same 25-point sweep.  --grid-diag restricts to p == q.
    n2v.add_argument("--grid", default=None)
    n2v.add_argument("--grid-diag", action="store_true")

    sr = sub.add_parser("simrank", help="exact SimRank -> top-k .sim.txt")
    sr.add_argument("--input", required=True)
    sr.add_argument("--output", required=True)
    sr.add_argument("--c", type=float, default=0.6)
    sr.add_argument("--iterations", type=int, default=3)
    sr.add_argument("--topk", type=int, default=20)
    sr.add_argument("--weighted", action="store_true")
    sr.add_argument("--delimiter", default=None)
    sr.add_argument(
        "--engine", default="dense", choices=["dense", "spmm"],
        help="dense matmul iterate or sparse CSR SpMM (sparse graphs)",
    )
    sr.add_argument(
        "--relabel", default="none",
        choices=["none", "bfs", "rcm", "degree"],
        help="locality relabeling before compute (gather locality); "
             "output ids are mapped back",
    )

    uw = sub.add_parser("uniwalk", help="single-walk MC SimRank")
    uw.add_argument("--input", required=True)
    uw.add_argument("--output", required=True)
    uw.add_argument("--sample", type=int, default=10000)
    uw.add_argument("--step", type=int, default=5)
    uw.add_argument("--topk", type=int, default=20)
    uw.add_argument("--delimiter", default=None)

    ts = sub.add_parser("topsim", help="TopSim deterministic spreading")
    ts.add_argument("--input", required=True)
    ts.add_argument("--output", required=True)
    ts.add_argument("--sample", type=float, default=10000.0)
    ts.add_argument("--step", type=int, default=3)
    ts.add_argument("--topk", type=int, default=20)
    ts.add_argument("--delimiter", default=None)
    ts.add_argument(
        "--engine", default="sample", choices=["sample", "enumerate"],
        help="budget-splitting (TopSim_singleSample) or full path "
             "enumeration (TopSim_Enumerate.java:101-129; exponential)",
    )
    ts.add_argument(
        "--frontier-capacity", type=int, default=0,
        help="walker slots per source (0 = auto bound)",
    )

    ds = sub.add_parser("deepsim", help="DeepSim AE over .sim.txt targets")
    ds.add_argument("--input", required=True)
    ds.add_argument("--simrank-path", required=True)
    ds.add_argument("--emb-output", required=True)
    ds.add_argument("--dimensions", type=int, default=128)
    ds.add_argument("--window-size", type=int, default=10)
    ds.add_argument("--vertex-num", type=int, default=0)
    ds.add_argument("--steps", type=int, default=50000)
    ds.add_argument("--walks-cache", default=None)
    ds.add_argument("--delimiter", default=None)

    sw = sub.add_parser("sweep", help="gold-standard precision sweep")
    sw.add_argument("--input", required=True)
    sw.add_argument("--log", required=True)
    sw.add_argument("--algorithm", choices=["uniwalk", "topsim"], default="uniwalk")
    sw.add_argument("--samples", type=int, nargs="+", default=None)
    sw.add_argument("--delimiter", default=None)

    # utils/GraphGenerator.java mains + GraphGeneratorBf + RMATGraphGenerator
    gen = sub.add_parser("generate", help="synthetic graph -> edge list")
    gen.add_argument("--output", required=True)
    gen.add_argument(
        "--kind",
        choices=["uniform", "bipartite", "directed", "rmat", "massive"],
        default="uniform",
    )
    gen.add_argument("--nodes", type=int, default=10000, help="V (left side for bipartite)")
    gen.add_argument("--right", type=int, default=0, help="right-side V for bipartite/massive")
    gen.add_argument("--avg-degree", type=int, default=10)
    gen.add_argument("--scale", type=int, default=14, help="rmat: V = 2^scale")
    gen.add_argument("--edges", type=int, default=0, help="rmat: edge count")
    gen.add_argument("--seed", type=int, default=0)

    # SDNE/SDNE.py training flow (sparse AE; reference trains it on MNIST)
    sd = sub.add_parser("sdne", help="SDNE sparse autoencoder -> embeddings")
    sd.add_argument("--input", required=True,
                    help="edge list; rows of the adjacency are the AE inputs")
    sd.add_argument("--output", required=True, help=".emb output")
    sd.add_argument("--steps", type=int, default=2000)
    sd.add_argument("--hidden", type=int, nargs="+", default=None,
                    help="encoder widths, e.g. 400 100 (reference MNIST net)")
    sd.add_argument("--delimiter", default=None)

    # IsoMap_LE flows: LE.py swiss-roll demo / simRank.py .sim.txt embedding
    le = sub.add_parser("le", help="Laplacian Eigenmaps embedding")
    le.add_argument("--input", default=None,
                    help=".sim.txt top-k file (simRank.py flow); omit for the swiss-roll demo")
    le.add_argument("--output", required=True, help=".npy 2-d embedding (and .png if --plot)")
    le.add_argument("--nodes", type=int, default=0)
    le.add_argument("--plot", action="store_true")
    le.add_argument("--k", type=int, default=10)
    le.add_argument("--t", type=float, default=15.0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import graphtpu
    from graphtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "node2vec":
        from graphtpu.core.config import SGNSConfig, WalkConfig
        from graphtpu.pipelines import node2vec_pipeline

        g = graphtpu.read_edgelist_graph(
            args.input, delimiter=args.delimiter,
            weighted=args.weighted, directed=args.directed,
        )
        if args.directed:
            g = g.out
        if args.grid:
            vals = [float(x) for x in args.grid.split(",")]
            # reference protocol is the full cross product
            # (node2vec/src/main.py:119-124)
            pqs = (
                [(x, x) for x in vals]
                if args.grid_diag
                else [(pp, qq) for pp in vals for qq in vals]
            )
        else:
            pqs = [(args.p, args.q)]
        for p, q in pqs:
            out = (
                args.output
                if len(pqs) == 1
                else f"{args.output}.p{p:g}_q{q:g}.emb"
            )
            node2vec_pipeline(
                g,
                walk_cfg=WalkConfig(
                    num_walks=args.num_walks, walk_length=args.walk_length,
                    p=p, q=q,
                ),
                sgns_cfg=SGNSConfig(
                    dim=args.dimensions, window=args.window_size,
                    epochs=args.iter, subsample=args.subsample, seed=args.seed,
                ),
                seed=args.seed,
                output=out,
            )
            print(f"wrote {out}")
        return 0

    if args.cmd == "generate":
        from graphtpu.bench import generators as gen

        if args.kind == "massive":
            n = gen.massive_bipartite_graph(
                args.nodes, args.right or args.nodes, args.avg_degree,
                args.output, seed=args.seed,
            )
            print(f"wrote {args.output}: {n} edges")
            return 0
        if args.kind == "uniform":
            edges = gen.uniform_random_graph(args.nodes, args.avg_degree, args.seed)
        elif args.kind == "bipartite":
            edges = gen.bipartite_random_graph(
                args.nodes, args.right or args.nodes, args.avg_degree, args.seed
            )
        elif args.kind == "directed":
            edges = gen.directed_random_graph(args.nodes, args.avg_degree, args.seed)
        else:  # rmat
            m = args.edges or (1 << args.scale) * args.avg_degree // 2
            edges = gen.rmat_graph(args.scale, m, seed=args.seed)
        np.savetxt(args.output, edges, fmt="%d")
        print(f"wrote {args.output}: {len(edges)} edges")
        return 0

    if args.cmd == "le":
        from graphtpu.core.config import LEConfig
        from graphtpu.models.lapeigen import (
            le_embed_points,
            le_embed_sim_dict,
            make_swiss_roll,
        )

        cfg = LEConfig(k_neighbors=args.k, heat_t=args.t)
        if args.input:
            from graphtpu.io.simfile import read_sim_file

            sims = read_sim_file(args.input)
            n = args.nodes or (
                max(max(s for s in sims), max(d for ps in sims.values() for d, _ in ps)) + 1
            )
            y, _ = le_embed_sim_dict(sims, n, cfg)
        else:
            pts = make_swiss_roll(2000)
            y, _ = le_embed_points(pts, cfg)
        np.save(args.output, y)
        print(f"wrote {args.output}.npy" if not args.output.endswith(".npy")
              else f"wrote {args.output}")
        if args.plot:
            from graphtpu.viz import plot_embedding_2d

            png = args.output.rsplit(".npy", 1)[0] + ".png"
            plot_embedding_2d(y, png)
            print(f"wrote {png}")
        return 0

    g = graphtpu.read_edgelist_graph(
        args.input, delimiter=getattr(args, "delimiter", None),
        weighted=getattr(args, "weighted", False),
    )

    if args.cmd == "sdne":
        import jax.numpy as jnp

        from graphtpu.core.config import SDNEConfig
        from graphtpu.core.graph import dense_adjacency
        from graphtpu.io.embfile import write_emb
        from graphtpu.models.sdne import train_sdne

        x = np.asarray(dense_adjacency(g))
        units = (
            [x.shape[1], *args.hidden, x.shape[1]]
            if args.hidden
            else [x.shape[1], 400, 100, 300, x.shape[1]]
        )
        cfg = SDNEConfig(units=tuple(units))
        _, embed = train_sdne(x, cfg, steps=args.steps, log_every=max(args.steps // 10, 1))
        write_emb(args.output, embed(x))
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "simrank":
        import jax.numpy as jnp

        from graphtpu.core.config import SimRankConfig
        from graphtpu.io.simfile import write_topk_files
        from graphtpu.kernels.topk import topk_rows
        from graphtpu.simrank.exact import exact_simrank, exact_simrank_spmm

        cfg = SimRankConfig(c=args.c, iterations=args.iterations)
        order = None
        if args.relabel != "none":
            from graphtpu.core.reorder import (
                bfs_order,
                degree_order,
                rcm_order,
                relabel_graph,
            )

            ofn = {"bfs": bfs_order, "rcm": rcm_order,
                   "degree": degree_order}[args.relabel]
            order = np.asarray(ofn(g), np.int64)
            g, inv = relabel_graph(g, order)
        if args.engine == "spmm":
            sim = exact_simrank_spmm(g, cfg, weighted=args.weighted)
        else:
            sim = exact_simrank(g, cfg, weighted=args.weighted)
        vals, idx = topk_rows(jnp.asarray(sim), args.topk)
        vals, idx = np.asarray(vals), np.asarray(idx)
        if order is not None:
            # map back to original ids: row new_i is original order[new_i],
            # neighbour new_j is original order[new_j]
            inv_rows = np.asarray(inv, np.int64)  # inv[old] = new
            vals = vals[inv_rows]
            idx = order[idx[inv_rows]].astype(np.int32)
        write_topk_files(args.output, idx, vals)
        print(f"wrote {args.output}(.sim.txt)")
        return 0

    if args.cmd == "uniwalk":
        from graphtpu.core.config import UniWalkConfig
        from graphtpu.io.simfile import write_topk_files
        from graphtpu.simrank.uniwalk import uniwalk_simrank

        vals, idx = uniwalk_simrank(
            g, UniWalkConfig(sample=args.sample, step=args.step, topk=args.topk)
        )
        write_topk_files(args.output, idx, vals)
        print(f"wrote {args.output}(.sim.txt)")
        return 0

    if args.cmd == "topsim":
        from graphtpu.core.config import TopSimConfig
        from graphtpu.io.simfile import write_topk_files
        from graphtpu.simrank.topsim import topsim_simrank

        vals, idx = topsim_simrank(
            g,
            TopSimConfig(
                sample=args.sample, step=args.step, topk=args.topk,
                enumerate_all=(args.engine == "enumerate"),
                frontier_capacity=args.frontier_capacity,
            ),
        )
        write_topk_files(args.output, idx, vals)
        print(f"wrote {args.output}(.sim.txt)")
        return 0

    if args.cmd == "deepsim":
        from graphtpu.core.config import DeepSimConfig, WalkConfig
        from graphtpu.io.embfile import write_emb
        from graphtpu.pipelines_deepsim import deepsim_pipeline

        emb = deepsim_pipeline(
            g,
            simrank_path=args.simrank_path,
            cfg=DeepSimConfig(dim=args.dimensions, window=args.window_size),
            walk_cfg=WalkConfig(),
            walks_cache=args.walks_cache,
            steps=args.steps,
        )
        write_emb(args.emb_output, emb)
        print(f"wrote {args.emb_output}")
        return 0

    if args.cmd == "sweep":
        from graphtpu.bench.sweep import (
            REFERENCE_SAMPLE_GRID,
            gold_standard,
            sweep_topsim,
            sweep_uniwalk,
        )
        from graphtpu.utils.logging import Log

        gold = gold_standard(g)
        samples = args.samples or REFERENCE_SAMPLE_GRID
        with Log(args.log) as log:
            if args.algorithm == "uniwalk":
                res = sweep_uniwalk(g, gold, samples=samples, log=log)
            else:
                res = sweep_topsim(g, gold, samples=samples, log=log)
        for r in res:
            print(f"{r.algorithm} sample={r.sample}: precision={r.precision:.4f} "
                  f"ndcg={r.ndcg:.4f} ({r.seconds:.1f}s)")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
