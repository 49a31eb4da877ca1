"""SpMM (kernels/spmm.py) parity tests: the XLA gather tree, the Triton
CSR kernel in interpret mode, and the SimRank engine built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import graphtpu
from graphtpu.core.config import SimRankConfig
from graphtpu.kernels.spmm import (
    CsrPlan,
    ReductionTree,
    _csr_spmm_call,
    build_csr_plan,
    build_reduction_tree,
    csr_spmm,
    spmm_oracle,
    tree_spmm,
)
from graphtpu.simrank import exact as exact_mod
from graphtpu.simrank.exact import (
    directed_simrank_reference_oracle,
    exact_simrank,
    exact_simrank_reference_oracle,
    exact_simrank_spmm,
    weighted_simrank_reference_oracle,
)


def _graph(v=67, e=600, seed=0, weighted=False, hub=True):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    if hub:  # force a node whose degree exceeds width**2 (3 tree levels)
        hub_edges = np.stack(
            [np.zeros(v - 2, np.int64), np.arange(1, v - 1)], 1
        )
        edges = np.concatenate([edges, hub_edges])
    # node v-1 stays isolated (zero row)
    edges = edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    return graphtpu.build_graph(edges, weights=wts, n_nodes=v)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_tree_spmm_matches_oracle(weighted, width):
    g = _graph(weighted=weighted)
    tree = build_reduction_tree(g, width=width, weighted=weighted)
    assert len(tree.levels) >= 3  # hub degree > width**2
    rng = np.random.default_rng(1)
    x = rng.random((g.n_nodes, 33)).astype(np.float32)
    got = np.asarray(jax.jit(lambda x: tree_spmm(tree, x))(jnp.asarray(x)))
    want = spmm_oracle(g, x, weighted=weighted)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # isolated node -> zero output row
    assert np.all(got[g.n_nodes - 1] == 0)


def test_tree_spmm_column_blocking():
    g = _graph(hub=False)
    tree = build_reduction_tree(g, width=8)
    rng = np.random.default_rng(2)
    x = rng.random((g.n_nodes, 70)).astype(np.float32)  # 70 = 2*32 + 6 tail
    got = np.asarray(
        jax.jit(lambda x: tree_spmm(tree, x, col_block=32))(jnp.asarray(x))
    )
    want = spmm_oracle(g, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_simrank_spmm_matches_dense(small_random, weighted):
    g = small_random
    cfg = SimRankConfig(iterations=4)
    dense = np.asarray(exact_simrank(g, cfg, weighted=weighted))
    sparse = np.asarray(
        exact_simrank_spmm(g, cfg, weighted=weighted, col_block=48)
    )
    np.testing.assert_allclose(sparse, dense, atol=2e-5)




@pytest.mark.parametrize(
    "c,col_block", [(1, 4096), (7, 3), (64, 16), (100, 48), (129, 64), (33, 33)]
)
def test_tree_spmm_widths_and_blocks(c, col_block):
    """Any width and column block, dividing or not (balanced blocks pad
    the last one with zero columns that are cut off again)."""
    g = _graph(seed=c)
    tree = build_reduction_tree(g, width=8)
    x = np.random.default_rng(c).random((g.n_nodes, c)).astype(np.float32)
    got = np.asarray(
        jax.jit(lambda x: tree_spmm(tree, x, col_block=col_block))(
            jnp.asarray(x)
        )
    )
    assert got.shape == (g.n_nodes, c)
    np.testing.assert_allclose(got, spmm_oracle(g, x), atol=1e-5)


def _simrank_case(kind):
    """(graph, float64 oracle scores, weighted flag) for one graph kind."""
    if kind == "weighted":
        g = _graph(v=24, e=90, seed=5, weighted=True, hub=False)
        return g, weighted_simrank_reference_oracle(g, 0.6, 3), True
    if kind == "directed":
        rng = np.random.default_rng(6)
        edges = rng.integers(0, 20, size=(70, 2))
        edges = edges[edges[:, 0] != edges[:, 1]]
        g = graphtpu.build_graph(edges, n_nodes=20, directed=True)
        return g, directed_simrank_reference_oracle(g, 0.6, 3), False
    if kind == "hub":  # hub degree > width**2: a 3-level tree
        g = _graph(v=40, e=120, seed=7, hub=True)
        assert len(build_reduction_tree(g, width=4).levels) >= 3
        return g, exact_simrank_reference_oracle(g, 0.6, 3), False
    g = _graph(v=24, e=60, seed=8, hub=False)  # node 23 isolated
    assert int(np.asarray(g.deg)[-1]) == 0
    return g, exact_simrank_reference_oracle(g, 0.6, 3), False


@pytest.mark.parametrize("kind", ["weighted", "directed", "hub", "isolated"])
def test_exact_simrank_spmm_matches_float64_oracle(kind):
    g, want, weighted = _simrank_case(kind)
    got = np.asarray(
        exact_simrank_spmm(
            g, SimRankConfig(c=0.6, iterations=3), weighted=weighted, width=4
        )
    )
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert np.all(np.diag(got) == 0)


def test_exact_simrank_spmm_bf16_iterates_keep_ranking(small_random):
    """bf16 stored iterates (f32 sums) keep each row's top-5 neighbours
    close to the f32 run; bf16 holds ~3 decimal digits, so ranking is
    the contract, not values."""
    cfg = SimRankConfig(iterations=4)
    f32 = np.asarray(exact_simrank_spmm(small_random, cfg))
    b16 = np.asarray(
        exact_simrank_spmm(small_random, cfg, dtype=jnp.bfloat16)
    ).astype(np.float32)
    assert np.abs(b16 - f32).max() < 1e-2
    k = 5
    agree = np.mean([
        len(set(np.argsort(-f32[r])[:k]) & set(np.argsort(-b16[r])[:k])) / k
        for r in range(f32.shape[0])
    ])
    assert agree >= 0.8, agree


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("c,col_block,nbr_block", [
    (33, 16, 4),   # masked column tail, several neighbour steps per row
    (64, 64, 16),  # one column block
    (5, 8, 8),     # block wider than the matrix
])
def test_csr_spmm_interpret_matches_oracle(weighted, c, col_block, nbr_block):
    """The Triton CSR kernel's program, run by the Pallas interpreter,
    against the numpy product (hub row, isolated row, weights)."""
    g = _graph(v=40, e=300, seed=c, weighted=weighted, hub=True)
    plan = build_csr_plan(g, weighted=weighted, nbr_block=nbr_block)
    x = np.random.default_rng(c).random((g.n_nodes, c)).astype(np.float32)
    got = np.asarray(
        _csr_spmm_call(plan, jnp.asarray(x), col_block, 4, 2, True)
    )
    np.testing.assert_allclose(
        got, spmm_oracle(g, x, weighted=weighted), atol=1e-5
    )
    assert np.all(got[g.n_nodes - 1] == 0)


def test_csr_plan_layout():
    """Row scale folded into vals; ``nbr_block`` zero slots past the end."""
    g = _graph(v=30, e=100, seed=3, weighted=True, hub=False)
    plan = build_csr_plan(g, weighted=True, nbr_block=8)
    rp, vals = np.asarray(plan.row_ptr), np.asarray(plan.vals)
    assert plan.col.shape == plan.vals.shape == (g.n_edges + 8,)
    assert np.all(vals[g.n_edges:] == 0)
    sums = np.add.reduceat(vals[: g.n_edges], rp[:-1][np.diff(rp) > 0])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


@pytest.mark.parametrize("backend,kind", [("cpu", ReductionTree),
                                          ("gpu", CsrPlan)])
def test_build_spmm_plan_picks_by_backend(monkeypatch, backend, kind):
    """The GPU takes the Triton CSR plan; any other backend the tree."""
    monkeypatch.setattr(exact_mod, "spmm_backend", lambda: backend)
    plan = exact_mod.build_spmm_plan(_graph(hub=False))
    assert isinstance(plan, kind)


@pytest.mark.gpu
def test_csr_spmm_compiled_matches_tree(gpu):
    """The kernel as compiled for the card against the XLA tree."""
    g = _graph(v=300, e=4000, seed=9, hub=True)
    x = jnp.asarray(
        np.random.default_rng(9).random((g.n_nodes, 700)).astype(np.float32)
    )
    got = jax.jit(csr_spmm)(build_csr_plan(g), x)
    want = jax.jit(tree_spmm)(build_reduction_tree(g), x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
