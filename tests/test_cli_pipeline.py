import os

import numpy as np
import pytest

import graphtpu
from graphtpu.cli import main as cli_main
from graphtpu.io.edgelist import write_edgelist
from graphtpu.io.simfile import read_sim_file
from graphtpu.io.embfile import read_emb
from graphtpu.pipelines_deepsim import (
    deepsim_pipeline,
    edge_label_homophily,
    load_walks,
    read_simrank,
    save_walks,
    simrank_label_agreement,
)


@pytest.fixture()
def graph_file(tmp_path, small_random):
    path = str(tmp_path / "g.txt")
    rp = np.asarray(small_random.row_ptr)
    col = np.asarray(small_random.col)
    edges = []
    for u in range(small_random.n_nodes):
        for v in col[rp[u] : rp[u + 1]]:
            if u < v:
                edges.append([u, v])
    write_edgelist(path, np.asarray(edges))
    return path


def test_cli_node2vec(tmp_path, graph_file):
    out = str(tmp_path / "o.emb")
    rc = cli_main([
        "node2vec", "--input", graph_file, "--output", out,
        "--dimensions", "8", "--walk-length", "10", "--num-walks", "2",
        "--window-size", "3", "--iter", "1", "--p", "0.5", "--q", "2.0",
        "--subsample", "0",
    ])
    assert rc == 0
    labels, vecs = read_emb(out)
    assert vecs.shape[1] == 8 and len(labels) == 64


def test_cli_simrank_and_uniwalk(tmp_path, graph_file):
    out = str(tmp_path / "sr.txt")
    assert cli_main(["simrank", "--input", graph_file, "--output", out,
                     "--iterations", "3", "--topk", "5"]) == 0
    sims = read_sim_file(out + ".sim.txt")
    assert len(sims) == 64
    out2 = str(tmp_path / "uw.txt")
    assert cli_main(["uniwalk", "--input", graph_file, "--output", out2,
                     "--sample", "200", "--step", "2", "--topk", "5"]) == 0
    assert os.path.exists(out2 + ".sim.txt")


def test_cli_sweep(tmp_path, graph_file):
    log = str(tmp_path / "s.log")
    assert cli_main(["sweep", "--input", graph_file, "--log", log,
                     "--samples", "100", "200"]) == 0
    assert "precision" in open(log).read() or os.path.getsize(log) > 0


def test_walks_cache_roundtrip(tmp_path, small_random):
    import jax
    from graphtpu.walks.walker import simulate_walks

    walks = np.asarray(simulate_walks(small_random, 1, 8, jax.random.key(0)))
    p = str(tmp_path / "walks.txt")
    save_walks(p, walks)
    back = load_walks(p, 8)
    np.testing.assert_array_equal(back, walks)


def test_deepsim_pipeline_file_boundary(tmp_path, small_random):
    import jax.numpy as jnp
    from graphtpu.core.config import DeepSimConfig, WalkConfig
    from graphtpu.io.simfile import write_topk_files
    from graphtpu.kernels.topk import topk_rows
    from graphtpu.simrank.exact import exact_simrank

    sim = exact_simrank(small_random)
    vals, idx = topk_rows(jnp.asarray(sim), 10)
    _, simpath = write_topk_files(
        str(tmp_path / "sr.txt"), np.asarray(idx), np.asarray(vals)
    )
    cache = str(tmp_path / "walks.txt")
    emb = deepsim_pipeline(
        small_random, simpath,
        cfg=DeepSimConfig(dim=8, window=2, minibatch=16),
        walk_cfg=WalkConfig(num_walks=2, walk_length=10),
        walks_cache=cache, steps=20,
    )
    assert emb.shape == (64, 8)
    assert os.path.exists(cache)
    # second run consumes the cache (no regeneration)
    emb2 = deepsim_pipeline(
        small_random, simpath,
        cfg=DeepSimConfig(dim=8, window=2, minibatch=16),
        walk_cfg=WalkConfig(num_walks=2, walk_length=10),
        walks_cache=cache, steps=20,
    )
    assert emb2.shape == (64, 8)


def test_diagnostics(small_random):
    labels = [[i % 3] for i in range(64)]
    sim_dict = {0: [(1, 0.5), (3, 0.4)], 1: [(4, 0.2)]}
    agree = simrank_label_agreement(sim_dict, labels)
    # (0,3) share label 0, (1,4) share label 1, (0,1) differ -> 2/3
    np.testing.assert_allclose(agree, 2 / 3)
    h = edge_label_homophily(small_random, labels)
    assert 0.0 <= h <= 1.0


def test_cli_generate(tmp_path):
    out = str(tmp_path / "gen.txt")
    assert cli_main(["generate", "--output", out, "--kind", "rmat",
                     "--scale", "8", "--edges", "2000", "--seed", "1"]) == 0
    e = np.loadtxt(out, dtype=np.int64)
    assert e.max() < 256 and len(e) > 1500
    out2 = str(tmp_path / "massive.txt")
    assert cli_main(["generate", "--output", out2, "--kind", "massive",
                     "--nodes", "1000", "--right", "1000",
                     "--avg-degree", "4"]) == 0
    lines = open(out2).read().strip().split("\n")
    assert len(set(lines)) == len(lines) == 4000


def test_cli_sdne_and_le(tmp_path, graph_file):
    out = str(tmp_path / "sdne.emb")
    assert cli_main(["sdne", "--input", graph_file, "--output", out,
                     "--steps", "5", "--hidden", "16", "8", "12"]) == 0
    _, vecs = read_emb(out)
    assert vecs.shape == (64, 8)
    # LE swiss-roll demo flow
    le_out = str(tmp_path / "le.npy")
    assert cli_main(["le", "--output", le_out]) == 0
    y = np.load(le_out)
    assert y.shape == (2000, 2)
    # LE .sim.txt flow reuses the simrank CLI output
    sr = str(tmp_path / "sr")
    assert cli_main(["simrank", "--input", graph_file, "--output", sr,
                     "--iterations", "2", "--topk", "5"]) == 0
    le2 = str(tmp_path / "le2.npy")
    assert cli_main(["le", "--input", sr + ".sim.txt", "--output", le2,
                     "--nodes", "64"]) == 0
    assert np.load(le2).shape[0] == 64


def test_cli_node2vec_grid_cross_product(tmp_path, graph_file):
    """--grid sweeps the FULL p x q cross product, one .emb per point
    (node2vec/src/main.py:119-124 nested ps/qs loops)."""
    out = str(tmp_path / "g.emb")
    rc = cli_main([
        "node2vec", "--input", graph_file, "--output", out,
        "--dimensions", "4", "--walk-length", "6", "--num-walks", "1",
        "--window-size", "2", "--iter", "1", "--subsample", "0",
        "--grid", "0.5,2",
    ])
    assert rc == 0
    for p in (0.5, 2.0):
        for q in (0.5, 2.0):
            labels, vecs = read_emb(f"{out}.p{p:g}_q{q:g}.emb")
            assert vecs.shape[1] == 4


def test_cli_topsim_enumerate(tmp_path, graph_file):
    out = str(tmp_path / "ts_enum.txt")
    rc = cli_main([
        "topsim", "--input", graph_file, "--output", out,
        "--engine", "enumerate", "--sample", "100", "--step", "2",
        "--topk", "5", "--frontier-capacity", "4096",
    ])
    assert rc == 0
    sims = read_sim_file(out + ".sim.txt")
    assert len(sims) > 0


def test_cli_simrank_relabel_maps_back(tmp_path, graph_file):
    """--relabel computes on the reordered graph but writes ORIGINAL ids:
    output must match the unrelabelled run exactly."""
    out0 = str(tmp_path / "plain.txt")
    out1 = str(tmp_path / "rcm.txt")
    common = ["simrank", "--input", graph_file, "--iterations", "3",
              "--topk", "5"]
    assert cli_main(common + ["--output", out0]) == 0
    assert cli_main(common + ["--output", out1, "--relabel", "rcm"]) == 0
    s0 = read_sim_file(out0 + ".sim.txt")
    s1 = read_sim_file(out1 + ".sim.txt")
    assert set(s0) == set(s1)
    for node, pairs in s0.items():
        d0 = dict(pairs)
        d1 = dict(s1[node])
        # ties at the top-k boundary may order differently; compare values
        for k in set(d0) & set(d1):
            assert abs(d0[k] - d1[k]) < 1e-5
        assert len(set(d0) & set(d1)) >= len(d0) - 2


@pytest.mark.parametrize("relabel", ["none", "rcm"])
def test_cli_simrank_spmm_matches_dense(tmp_path, graph_file, relabel):
    """``simrank --engine spmm`` writes the same top-k as ``--engine
    dense`` (scores to the two f32 engines' 2e-5), relabelled or not."""
    sims = {}
    for engine in ("dense", "spmm"):
        out = str(tmp_path / engine)
        assert cli_main([
            "simrank", "--input", graph_file, "--output", out,
            "--engine", engine, "--relabel", relabel,
            "--iterations", "4", "--topk", "6",
        ]) == 0
        sims[engine] = read_sim_file(out + ".sim.txt")
    assert sims["dense"].keys() == sims["spmm"].keys()
    for src, pairs in sims["dense"].items():
        want = np.array([v for _, v in pairs])
        got = np.array([v for _, v in sims["spmm"][src]])
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_rmat_unique_edges_exact_count_and_seeded():
    from graphtpu.bench.generators import rmat_unique_edges

    e = rmat_unique_edges(1000, 5000, seed=3)
    assert e.shape == (5000, 2)
    assert e.min() >= 0 and e.max() < 1000
    assert np.all(e[:, 0] != e[:, 1])
    key = np.minimum(e[:, 0], e[:, 1]) * 1000 + np.maximum(e[:, 0], e[:, 1])
    assert len(np.unique(key)) == 5000
    np.testing.assert_array_equal(e, rmat_unique_edges(1000, 5000, seed=3))
    assert not np.array_equal(e, rmat_unique_edges(1000, 5000, seed=4))
    with pytest.raises(ValueError):
        rmat_unique_edges(10, 100, seed=0)  # only 45 pairs exist
