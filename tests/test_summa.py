"""2-D SUMMA sharded SimRank (dist/spmm_summa.py) on the virtual mesh."""

import jax
import jax.numpy as jnp
import numpy as np

import graphtpu
from graphtpu.core.config import SimRankConfig
from graphtpu.dist.spmm_summa import (
    build_summa_plan,
    make_2d_mesh,
    make_summa_iter,
    summa_simrank_spmm,
)
from graphtpu.simrank.exact import exact_simrank


def test_summa_matches_single_device_all_grids(small_random):
    g = small_random
    cfg = SimRankConfig(iterations=3)
    want = np.asarray(exact_simrank(g, cfg))
    for r, c in [(4, 2), (2, 4), (2, 2)]:
        mesh = make_2d_mesh(r, c)
        got = np.asarray(summa_simrank_spmm(g, mesh, cfg))
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=f"{r}x{c}")


def test_summa_weighted_matches_single_device():
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 40, size=(150, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate(
        [edges, np.stack([np.arange(40), (np.arange(40) + 1) % 40], 1)]
    )
    wts = rng.random(len(edges)).astype(np.float32) + 0.1
    g = graphtpu.build_graph(edges, wts, n_nodes=40)
    cfg = SimRankConfig(iterations=3)
    want = np.asarray(exact_simrank(g, cfg, weighted=True))
    mesh = make_2d_mesh(2, 4)
    got = np.asarray(summa_simrank_spmm(g, mesh, cfg, weighted=True))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_summa_bf16_iterates(small_random):
    """bf16 form: bf16 blocks on every wire (ring + reduce + a2a), f32
    tree accumulation — top-k structure survives."""
    g = small_random
    cfg = SimRankConfig(iterations=3)
    want = np.asarray(exact_simrank(g, cfg))
    mesh = make_2d_mesh(4, 2)
    got = np.asarray(
        summa_simrank_spmm(g, mesh, cfg, dtype=jnp.bfloat16)
    ).astype(np.float32)
    # bf16 has ~3 decimal digits; rank agreement is the bf16 contract
    agree = 0
    for i in range(g.n_nodes):
        agree += len(
            set(np.argsort(-want[i])[:5]) & set(np.argsort(-got[i])[:5])
        )
    assert agree / (5 * g.n_nodes) > 0.9
    np.testing.assert_allclose(got, want, atol=0.02)


def test_summa_per_device_memory_is_blocked(small_random):
    """Compiled per-device footprint stays O(V²/n + E/n): the iteration
    argument is the [V/c, V/r] block stack, never a replicated [V, V]."""
    g = small_random
    mesh = make_2d_mesh(4, 2)
    plan, v, init, run_n, zero_diag = make_summa_iter(
        g, mesh, SimRankConfig(iterations=2)
    )
    s = init(jnp.zeros((4, 2), jnp.float32))
    # the carried global array is [V, V] but sharded (pc, pr): each
    # addressable shard holds exactly V/c x V/r
    assert s.shape == (v, v)
    shard_shapes = {sh.data.shape for sh in s.addressable_shards}
    assert shard_shapes == {(v // 2, v // 4)}
    lowered = run_n.lower(s, 2, *(plan.levels + plan.weights))
    mem = lowered.compile().memory_analysis()
    # generous bound: a replicated-V² design would need >= v*v*4 bytes
    # of argument space PER DEVICE; the blocked one needs ~v*v*4/8 (+
    # plan + temps).  Assert we are well under the replicated floor.
    assert mem.argument_size_in_bytes < v * v * 4, (
        mem.argument_size_in_bytes,
        v * v * 4,
    )


def test_summa_plan_is_column_restricted(small_random):
    """Every level-0 slot indexes inside the local k-block (< V/c)."""
    from graphtpu.core.graph import pad_graph_nodes

    g = small_random
    r, c = 2, 4
    v = -(-g.n_nodes // (r * c * 8)) * (r * c * 8)
    gp = pad_graph_nodes(g, v)
    plan = build_summa_plan(gp, r, c)
    kc = v // c
    lvl0 = np.asarray(plan.levels[0])
    assert lvl0.max() < kc
    # and the plan rows end at rows_per for every block
    assert np.asarray(plan.levels[-1]).shape[2] >= v // r


def test_summa_directed_matches_single_device():
    """DiGraph -> in-neighbour rows, matching exact_simrank's DGraph
    semantics (structures/DGraph.java)."""
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 32, size=(200, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = graphtpu.build_graph(edges, n_nodes=32, directed=True)
    cfg = SimRankConfig(iterations=3)
    want = np.asarray(exact_simrank(g, cfg))
    mesh = make_2d_mesh(2, 2)
    got = np.asarray(summa_simrank_spmm(g, mesh, cfg))
    np.testing.assert_allclose(got, want, atol=5e-5)
