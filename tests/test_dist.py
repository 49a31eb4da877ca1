"""Multi-device tests on the virtual 8-device CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from jax import shard_map
from functools import partial

import graphtpu
from graphtpu.core.config import SGNSConfig, SimRankConfig
from graphtpu.dist.mesh import make_mesh, make_1d_mesh
from graphtpu.dist.sgns_dp import make_sgns_train_step
from graphtpu.dist.simrank_sharded import sharded_exact_simrank
from graphtpu.dist.frontier import (
    _pack_buckets,
    exchange_by_owner,
    distributed_uniform_walks,
)
from graphtpu.simrank.exact import exact_simrank


def test_mesh_shapes():
    m = make_mesh(8, model_parallel=2)
    assert m.devices.shape == (4, 2)
    assert m.axis_names == ("data", "model")


def test_pack_buckets():
    pay = jnp.array([10, 11, 12, 13, 14], jnp.int32)
    owner = jnp.array([1, 0, 1, -1, 0], jnp.int32)
    b = np.asarray(_pack_buckets(pay, owner, 2, 3, -1))
    assert sorted(b[0][b[0] >= 0].tolist()) == [11, 14]
    assert sorted(b[1][b[1] >= 0].tolist()) == [10, 12]


def test_pack_buckets_overflow_drops():
    pay = jnp.arange(5, dtype=jnp.int32)
    owner = jnp.zeros(5, jnp.int32)
    b = np.asarray(_pack_buckets(pay, owner, 2, 3, -1))
    assert (b[0] >= 0).sum() == 3 and (b[1] >= 0).sum() == 0


def test_exchange_by_owner_routes_correctly():
    mesh = make_1d_mesh(4)
    n_dev, per = 4, 8

    @partial(shard_map, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))
    def run(x):
        # send every value to device (value % 4)
        owner = x % n_dev
        (recv,), _ = exchange_by_owner((x,), owner, "data", n_dev, per)
        return recv[None, :]

    x = jnp.arange(32, dtype=jnp.int32)
    out = np.asarray(run(x))  # [4, 32]
    for d in range(4):
        got = sorted(out[d][out[d] >= 0].tolist())
        want = sorted([v for v in range(32) if v % 4 == d])
        assert got == want, (d, got, want)


def test_distributed_walks_valid_edges(small_random):
    g = small_random
    mesh = make_1d_mesh(8)
    walks = distributed_uniform_walks(
        g, n_walkers=64, num_steps=6, key=jax.random.key(0), mesh=mesh
    )
    w = np.asarray(walks)
    assert w.shape == (64, 7)
    assert (w[:, 0] >= 0).all()
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col)
    for b in range(64):
        for t in range(6):
            u, v = w[b, t], w[b, t + 1]
            if v < 0:
                continue
            assert v in col[rp[u] : rp[u + 1]], (b, t, u, v)


def test_sharded_simrank_matches_single_device(small_random):
    g = small_random
    mesh = make_1d_mesh(8)
    got = np.asarray(sharded_exact_simrank(g, mesh, SimRankConfig(iterations=3)))
    want = np.asarray(exact_simrank(g, SimRankConfig(iterations=3)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_simrank_pads_v_to_the_mesh():
    """V=61 divides no 8-device axis: isolated pad nodes make it divide,
    and the real block comes back unchanged."""
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 61, size=(240, 2))
    g = graphtpu.build_graph(edges[edges[:, 0] != edges[:, 1]], n_nodes=61)
    cfg = SimRankConfig(iterations=3)
    got = sharded_exact_simrank(g, make_1d_mesh(8), cfg)
    assert got.shape == (61, 61)
    want = np.asarray(exact_simrank(g, cfg))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_train_sgns_mesh_pads_the_table_rows():
    """An odd vocabulary on a 2-wide 'model' axis: the tables gain one
    never-referenced pad row, and the trajectory and shapes match the
    single-device run."""
    from graphtpu.models.sgns import train_sgns
    from graphtpu.walks.walker import uniform_walks

    rng = np.random.default_rng(4)
    edges = rng.integers(0, 63, size=(300, 2))
    g = graphtpu.build_graph(edges[edges[:, 0] != edges[:, 1]], n_nodes=63)
    cfg = SGNSConfig(dim=8, window=3, negative=4, epochs=1, batch_size=64)
    starts = jnp.tile(jnp.arange(g.n_nodes, dtype=jnp.int32), 2)
    walks = np.asarray(uniform_walks(g, starts, 10, jax.random.key(2)))
    s0, s1 = train_sgns(walks, g.n_nodes, cfg)
    d0, d1 = train_sgns(walks, g.n_nodes, cfg,
                        mesh=make_mesh(4, model_parallel=2))
    assert d0.shape == d1.shape == (63, 8)
    np.testing.assert_allclose(d0, s0, atol=1e-5)
    np.testing.assert_allclose(d1, s1, atol=1e-5)


def test_sgns_dp_step_runs_and_matches_shapes():
    mesh = make_mesh(8, model_parallel=2)
    cfg = SGNSConfig(dim=32, window=2, negative=3)
    v = 64
    shard_params, shard_batch, train_step = make_sgns_train_step(mesh, cfg, v)
    rng = np.random.default_rng(0)
    params = shard_params(
        (
            jnp.asarray(rng.normal(size=(v, 32)).astype(np.float32)),
            jnp.zeros((v, 32), jnp.float32),
        )
    )
    b = 16
    centers = jnp.asarray(rng.integers(0, v, b).astype(np.int32))
    contexts = jnp.asarray(rng.integers(0, v, (b, 4)).astype(np.int32))
    mask = jnp.ones((b, 4), bool)
    negs = jnp.asarray(rng.integers(0, v, (b, 4, 3)).astype(np.int32))
    centers, contexts, mask, negs = shard_batch(centers, contexts, mask, negs)
    p1 = np.asarray(params[1])
    params = train_step(params, centers, contexts, mask, negs, 0.025)
    assert params[0].shape == (v, 32)
    # with syn1 = 0, grad(syn0) is exactly 0 on step one (gensim too);
    # syn1 must move
    assert not np.allclose(np.asarray(params[1]), p1)


def test_distributed_uniwalk_matches_exact_ranking(small_random):
    from graphtpu.core.config import UniWalkConfig, SimRankConfig
    from graphtpu.dist.uniwalk_dist import distributed_uniwalk_simrank

    g = small_random
    mesh = make_1d_mesh(8)
    vals, idx = distributed_uniwalk_simrank(
        g, mesh, UniWalkConfig(sample=6000, step=3, topk=5),
        key=jax.random.key(3),
    )
    assert vals.shape == (64, 5)
    exact = np.asarray(exact_simrank(g, SimRankConfig(iterations=3)))
    hits, total = 0, 0
    for r in range(64):
        ia = set(idx[r][vals[r] > 0].tolist())
        ib = set(np.argsort(-exact[r])[: len(ia)].tolist())
        if not ia:
            continue
        hits += len(ia & ib)
        total += len(ia)
    # calibrated: sample=6000 scores ~0.78 on this class of graph, and the
    # overlap must keep rising with budget (0.65 @ 1.5k -> 0.86 @ 20k);
    # a half-broken estimator plateaus near coin-flip territory instead.
    assert total > 0 and hits / total > 0.7, hits / max(total, 1)


def test_distributed_uniwalk_reuse_matches_exact_ranking(small_random):
    from graphtpu.core.config import UniWalkConfig, SimRankConfig
    from graphtpu.dist.uniwalk_dist import distributed_uniwalk_simrank_reuse

    g = small_random
    mesh = make_1d_mesh(8)
    vals, idx = distributed_uniwalk_simrank_reuse(
        g, mesh, UniWalkConfig(sample=6400, step=3, topk=5, reuse_times=4),
        key=jax.random.key(7),
    )
    assert vals.shape == (64, 5)
    assert (vals >= 0).all()
    exact = np.asarray(exact_simrank(g, SimRankConfig(iterations=3)))
    hits, total = 0, 0
    for r in range(64):
        ia = set(idx[r][vals[r] > 0].tolist())
        ib = set(np.argsort(-exact[r])[: len(ia)].tolist())
        if not ia:
            continue
        assert r not in ia  # diag zeroed on the owner shard
        hits += len(ia & ib)
        total += len(ia)
    # calibrated like the non-reuse test: ~0.79 at this budget, rising
    # with sample (0.61 @ 1.6k); exact value parity with the dense oracle
    # is covered separately by test_uniwalk_reuse_topk_matches_dense.
    assert total > 0 and hits / total > 0.7, hits / max(total, 1)


def _medium_random(v=256, e=2048, seed=3):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)
    return graphtpu.build_graph(np.concatenate([edges, ring]), n_nodes=v)


def test_shard_graph_roundtrip_and_locality():
    """Shards must partition the CSR exactly, and no device block may hold
    the full edge array (the graph exceeds one worker)."""
    from graphtpu.dist.sharded_graph import shard_graph

    g = _medium_random()
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    assert sg.e_cap < g.n_edges, (sg.e_cap, g.n_edges)
    # per-device blocks: [1, e_cap] each, physically on distinct devices
    assert len(sg.col.sharding.device_set) == 8
    # reconstruct the global CSR from the shards
    rp = np.asarray(sg.row_ptr)
    col = np.asarray(sg.col)
    deg = np.asarray(sg.deg)
    got_col, got_deg = [], []
    for d in range(8):
        n_local = int(rp[d, -1])
        got_col.append(col[d, :n_local])
        got_deg.append(deg[d])
    got_col = np.concatenate(got_col)
    got_deg = np.concatenate(got_deg)[: g.n_nodes]
    np.testing.assert_array_equal(got_col, np.asarray(g.col))
    np.testing.assert_array_equal(got_deg, np.asarray(g.deg))
    np.testing.assert_array_equal(
        np.asarray(sg.deg_global)[: g.n_nodes], np.asarray(g.deg)
    )


def test_distributed_walks_sharded_equals_replicated():
    """Same key: walking against local CSR shards must produce EXACTLY the
    walks of the replicated graph (routing and RNG streams are shared)."""
    from graphtpu.dist.sharded_graph import shard_graph

    g = _medium_random()
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    kw = dict(n_walkers=128, num_steps=6, key=jax.random.key(5), mesh=mesh)
    w_rep = np.asarray(distributed_uniform_walks(g, **kw))
    w_shd = np.asarray(distributed_uniform_walks(sg, **kw))
    np.testing.assert_array_equal(w_rep, w_shd)
    # and the walks are real edges
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col)
    for b in range(0, 128, 7):
        for t in range(6):
            u, v = w_shd[b, t], w_shd[b, t + 1]
            if v < 0:
                continue
            assert v in col[rp[u] : rp[u + 1]], (b, t, u, v)


def test_distributed_reuse_on_sharded_graph_equals_replicated():
    from graphtpu.core.config import UniWalkConfig
    from graphtpu.dist.sharded_graph import shard_graph
    from graphtpu.dist.uniwalk_dist import distributed_uniwalk_simrank_reuse

    g = _medium_random()
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    cfg = UniWalkConfig(sample=64, step=2, reuse_times=4, topk=5)
    v1, i1 = distributed_uniwalk_simrank_reuse(g, mesh, cfg, key=jax.random.key(2))
    v2, i2 = distributed_uniwalk_simrank_reuse(sg, mesh, cfg, key=jax.random.key(2))
    np.testing.assert_allclose(v1, v2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)


def test_distributed_uniwalk_reuse_equals_dense_oracle(small_random):
    """Feeding the SAME walks, the item-routed distributed flush must
    reproduce the single-device dense reuse oracle value-for-value (the
    routing and sort-based top-k change nothing but summation order)."""
    from graphtpu.core.config import UniWalkConfig
    from graphtpu.dist.uniwalk_dist import distributed_uniwalk_simrank_reuse
    from graphtpu.simrank.uniwalk import uniwalk_simrank_reuse
    from graphtpu.walks.walker import uniform_walks

    g = small_random
    mesh = make_1d_mesh(8)
    cfg = UniWalkConfig(sample=400, step=2, reuse_times=4, topk=5)
    wpn = cfg.sample // cfg.reuse_times
    starts = jnp.repeat(jnp.arange(g.n_nodes, dtype=jnp.int32), wpn)
    walks = uniform_walks(
        g, starts, 2 * cfg.step + cfg.reuse_times - 1, jax.random.key(13)
    )
    dense = uniwalk_simrank_reuse(g, cfg, walks=walks)
    vals, idx = distributed_uniwalk_simrank_reuse(g, mesh, cfg, walks=walks)
    for r in range(g.n_nodes):
        np.testing.assert_allclose(
            np.sort(vals[r])[::-1],
            np.sort(dense[r])[-cfg.topk:][::-1],
            atol=1e-5,
        )
        for j in range(cfg.topk):
            if idx[r, j] >= 0:
                np.testing.assert_allclose(
                    vals[r, j], dense[r, idx[r, j]], atol=1e-5
                )


def test_distributed_topsim_matches_local(small_random):
    from graphtpu.core.config import TopSimConfig
    from graphtpu.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu.simrank.topsim import topsim_simrank

    g = small_random
    mesh = make_1d_mesh(8)
    cfg = TopSimConfig(sample=2000.0, step=2, topk=5, source_tile=4)
    dv, di = distributed_topsim_simrank(g, mesh, cfg, key=jax.random.key(1))
    assert dv.shape == (64, 5)
    # statistical agreement with the local kernel (different RNG streams):
    lv, li = topsim_simrank(g, cfg, key=jax.random.key(2))
    hits = sum(
        len(set(di[r][dv[r] > 0]) & set(li[r][lv[r] > 0]))
        for r in range(64)
    )
    denom = sum(len(set(li[r][lv[r] > 0])) for r in range(64))
    # calibrated: 0.66 @ sample=500, 0.82 @ 2000, 0.92 @ 8000 — the two
    # streams converge on the same ranking as the budget grows.
    assert denom > 0 and hits / denom > 0.72, hits / max(denom, 1)


def test_train_sgns_dp_reproduces_single_device(small_random, tmp_path):
    """The END-TO-END distributed trainer (epochs, subsampling, dynamic
    windows, LR schedule) must reproduce the single-device trajectory —
    collectives change nothing but reduction order.  Also exercises
    checkpoint/resume under the mesh."""
    from graphtpu.dist.sgns_dp import train_sgns_dp
    from graphtpu.models.sgns import train_sgns
    from graphtpu.walks.walker import uniform_walks

    g = small_random
    cfg = SGNSConfig(dim=16, window=3, negative=4, epochs=2, batch_size=128)
    starts = jnp.tile(jnp.arange(g.n_nodes, dtype=jnp.int32), 3)
    walks = uniform_walks(g, starts, 12, jax.random.key(9))

    s0, s1 = train_sgns(np.asarray(walks), g.n_nodes, cfg)
    mesh = make_mesh(8, model_parallel=2)
    d0, d1 = train_sgns_dp(np.asarray(walks), g.n_nodes, mesh, cfg)
    # measured bit-identical on the virtual mesh; allow eps for platforms
    # where GSPMD reduction order differs
    np.testing.assert_allclose(d0, s0, atol=1e-6)
    np.testing.assert_allclose(d1, s1, atol=1e-6)

    # mesh checkpoint/resume: run 2-epoch training WITH periodic
    # checkpoints, rewind the durable state to a mid-run snapshot, resume
    # with the same config, and land on the same final tables
    import shutil

    ck = str(tmp_path / "sgns_dp.ckpt")
    snap = str(tmp_path / "snap.ckpt")
    calls = {"n": 0}
    orig_save = None
    from graphtpu.models import checkpoint as ckpt_mod

    orig_save = ckpt_mod.save_state

    def snapping_save(path, arrays, step=0, meta=None):
        orig_save(path, arrays, step=step, meta=meta)
        calls["n"] += 1
        if calls["n"] == 1:  # snapshot the FIRST mid-run checkpoint
            shutil.copy(path, snap)

    ckpt_mod.save_state = snapping_save
    try:
        # train_sgns imports save_state lazily from the module, so the
        # monkeypatch takes effect
        import graphtpu.models.sgns as sgns_mod

        train_sgns_dp(
            np.asarray(walks), g.n_nodes, mesh, cfg,
            checkpoint_path=ck, checkpoint_every=1,
        )
    finally:
        ckpt_mod.save_state = orig_save
    shutil.copy(snap, ck)  # rewind to mid-run (simulated crash)
    r0, r1 = train_sgns_dp(
        np.asarray(walks), g.n_nodes, mesh, cfg,
        checkpoint_path=ck, checkpoint_every=1,
    )
    np.testing.assert_allclose(r0, d0, atol=1e-6)


def test_sgns_dp_step_equals_single_device():
    """The sharded train step must produce the same update as the
    single-device manual-grad step (collectives change nothing)."""
    from graphtpu.models.sgns import sgns_manual_grads

    mesh = make_mesh(8, model_parallel=2)
    cfg = SGNSConfig(dim=16, window=2, negative=3)
    v, b = 48, 16
    rng = np.random.default_rng(1)
    p0 = jnp.asarray(rng.normal(scale=0.3, size=(v, 16)).astype(np.float32))
    p1 = jnp.asarray(rng.normal(scale=0.3, size=(v, 16)).astype(np.float32))
    centers = jnp.asarray(rng.integers(0, v, b).astype(np.int32))
    contexts = jnp.asarray(rng.integers(0, v, (b, 4)).astype(np.int32))
    mask = jnp.asarray(rng.random((b, 4)) < 0.8)
    negs = jnp.asarray(rng.integers(0, v, (b, 4, 3)).astype(np.int32))

    shard_params, shard_batch, train_step = make_sgns_train_step(mesh, cfg, v)
    sp = shard_params((p0, p1))
    sb = shard_batch(centers, contexts, mask, negs)
    out = train_step(sp, *sb, 0.05)

    (g0, g1), (c0, c1) = sgns_manual_grads((p0, p1), centers, contexts, mask, negs, v)
    want0 = p0 - 0.05 * g0 / jnp.maximum(c0, 1)[:, None]
    want1 = p1 - 0.05 * g1 / jnp.maximum(c1, 1)[:, None]
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(want0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(want1), atol=1e-5)


def test_sharded_topsim_matches_dense_deterministic(small_random):
    """Partitioned-graph TopSim == single-chip TopSim in the deterministic
    regime (mass >= degree everywhere -> every expansion is an even split,
    no sampling), so the owner-exchange routing must reproduce the local
    kernel's mass propagation exactly."""
    from graphtpu.core.config import TopSimConfig
    from graphtpu.dist.sharded_graph import shard_graph
    from graphtpu.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu.simrank.topsim import topsim_simrank

    # sparse graph (deg ~ 3) so the full deterministic split tree fits both
    # the local tile and the per-device exchange buckets with no drops
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 64, size=(100, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate(
        [edges, np.stack([np.arange(64), (np.arange(64) + 1) % 64], 1)]
    )
    g = graphtpu.build_graph(edges, n_nodes=64)
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    cfg = TopSimConfig(
        sample=1e6, step=2, topk=64, source_tile=8, frontier_capacity=16384
    )
    dv, di = distributed_topsim_simrank(
        sg, mesh, cfg, key=jax.random.key(1), device_capacity=65536
    )
    dense = np.asarray(
        topsim_simrank(g, cfg, key=jax.random.key(2), dense=True)
    )
    got = np.zeros_like(dense)
    for r in range(64):
        for v, i in zip(dv[r], di[r]):
            if i >= 0:
                got[r, i] = v
    np.testing.assert_allclose(got, dense, rtol=2e-3, atol=2e-6)


def test_sharded_topsim_statistical(small_random):
    """Sampled regime: partitioned TopSim agrees with the local kernel's
    ranking statistically (independent RNG streams)."""
    from graphtpu.core.config import TopSimConfig
    from graphtpu.dist.sharded_graph import shard_graph
    from graphtpu.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu.simrank.topsim import topsim_simrank

    g = small_random
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    cfg = TopSimConfig(sample=2000.0, step=2, topk=5, source_tile=4)
    dv, di = distributed_topsim_simrank(sg, mesh, cfg, key=jax.random.key(1))
    lv, li = topsim_simrank(g, cfg, key=jax.random.key(2))
    hits = sum(
        len(set(di[r][dv[r] > 0]) & set(li[r][lv[r] > 0])) for r in range(64)
    )
    denom = sum(len(set(li[r][lv[r] > 0])) for r in range(64))
    assert denom > 0 and hits / denom > 0.72, hits / max(denom, 1)


def test_sharded_spmm_simrank_matches_single_device(small_random):
    """Fully-partitioned sparse SimRank (S column-sharded, P row-sharded,
    ring-rotation products) == the single-device SpMM and dense forms."""
    from graphtpu.dist.spmm_sharded import (
        build_sharded_tree_plan,
        sharded_simrank_spmm,
    )
    from graphtpu.simrank.exact import exact_simrank_spmm

    g = small_random
    mesh = make_1d_mesh(8)
    cfg = SimRankConfig(iterations=4)
    got = np.asarray(sharded_simrank_spmm(g, mesh, cfg))
    want = np.asarray(exact_simrank_spmm(g, cfg))
    np.testing.assert_allclose(got, want, atol=1e-6)
    dense = np.asarray(exact_simrank(g, SimRankConfig(iterations=4)))
    np.testing.assert_allclose(got, dense, atol=1e-5)


def test_sharded_spmm_plan_memory_profile():
    """Each device's plan block must hold only ~E/n_dev level-0 slots and
    the stacked plan must be physically distributed."""
    from graphtpu.dist.spmm_sharded import build_sharded_tree_plan

    g = _medium_random(v=1024, e=8192)
    mesh = make_1d_mesh(8)
    plan = build_sharded_tree_plan(g, 8, mesh=mesh)
    lvl0 = plan.levels[0]
    # level-0 slots per device ~ E/n_dev (x width padding), far below E
    assert lvl0.shape[1] * lvl0.shape[2] < g.n_edges, (
        lvl0.shape, g.n_edges)
    assert len(lvl0.sharding.device_set) == 8


def test_distributed_node2vec_transition_parity():
    """Distributed second-order walks from a single start: the joint
    (hop1, hop2) distribution must match P_uniform(c1 | s0) x
    P_2nd(c2 | s0, c1) from the reference bias oracle."""
    from graphtpu.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu.dist.sharded_graph import shard_graph
    from graphtpu.walks.node2vec import node2vec_transition_probs

    rng = np.random.default_rng(4)
    edges = rng.integers(0, 48, size=(220, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate(
        [edges, np.stack([np.arange(48), (np.arange(48) + 1) % 48], 1)]
    )
    g = graphtpu.build_graph(edges, n_nodes=48)
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)

    s0 = int(np.argmax(np.asarray(g.deg)))
    p, q = 0.25, 2.0
    n = 16384
    w = np.asarray(
        distributed_node2vec_walks(
            sg, n, 2, p, q, jax.random.key(5), mesh,
            starts=jnp.full((n,), s0, jnp.int32),
        )
    )
    assert (w >= 0).all()
    v = g.n_nodes
    emp = np.zeros((v, v))
    np.add.at(emp, (w[:, 1], w[:, 2]), 1.0)
    emp /= n
    want = np.zeros((v, v))
    nbrs = np.asarray(g.col)[
        np.asarray(g.row_ptr)[s0] : np.asarray(g.row_ptr)[s0 + 1]
    ]
    for c1 in nbrs:
        want[c1] = node2vec_transition_probs(g, s0, int(c1), p, q) / len(nbrs)
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv < 0.12, tv


def test_distributed_weighted_walks_shard_equals_replicated():
    """Weighted sampling through the partitioned walker must reproduce the
    replicated path exactly under the same key (integer weights keep the
    per-row cumulative sums fp-exact)."""
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 64, size=(300, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate(
        [edges, np.stack([np.arange(64), (np.arange(64) + 1) % 64], 1)]
    )
    wts = rng.integers(1, 5, size=len(edges)).astype(np.float32)
    g = graphtpu.build_graph(edges, weights=wts, n_nodes=64)
    mesh = make_1d_mesh(8)
    from graphtpu.dist.sharded_graph import shard_graph

    sg = shard_graph(g, 8, mesh=mesh)
    a = np.asarray(distributed_uniform_walks(
        g, 64, 6, jax.random.key(11), mesh, weighted=True
    ))
    b = np.asarray(distributed_uniform_walks(
        sg, 64, 6, jax.random.key(11), mesh, weighted=True
    ))
    np.testing.assert_array_equal(a, b)
    # weights actually bias the draws: zero-weight edges never taken is
    # covered by sampling tests; here assert walks are valid edges
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col)
    for r in range(64):
        for t_ in range(6):
            u, x = b[r, t_], b[r, t_ + 1]
            if x < 0:
                continue
            assert x in col[rp[u] : rp[u + 1]]


def test_distributed_sgns_trains_on_node2vec_walks(small_random):
    """End-to-end: partitioned-graph second-order walks feed the
    data-parallel SGNS trainer (the reference's full node2vec pipeline,
    distributed)."""
    from graphtpu.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu.dist.sgns_dp import train_sgns_dp
    from graphtpu.dist.sharded_graph import shard_graph

    g = small_random
    mesh = make_1d_mesh(8)
    sg = shard_graph(g, 8, mesh=mesh)
    walks = distributed_node2vec_walks(
        sg, 128, 10, 0.25, 4.0, jax.random.key(2), mesh,
        starts=jnp.asarray(
            np.tile(np.arange(64, dtype=np.int32), 2)
        ),
    )
    cfg = SGNSConfig(dim=16, window=2, negative=2, epochs=1, batch_size=64)
    syn0, syn1 = train_sgns_dp(walks, 64, mesh, cfg, key=jax.random.key(3))
    assert syn0.shape == (64, 16) and np.isfinite(np.asarray(syn0)).all()
    assert not np.allclose(np.asarray(syn0), 0)


def test_distributed_uniwalk_internal_windowing(small_random):
    """A walk-tensor budget forces internal source windows; results must
    match the single-window run row-for-row in ranking quality (same
    estimator, different keys per window)."""
    from graphtpu.core.config import UniWalkConfig
    from graphtpu.dist.uniwalk_dist import distributed_uniwalk_simrank

    g = small_random
    mesh = make_1d_mesh(8)
    cfg = UniWalkConfig(sample=200, step=2, topk=5)
    # budget forces ~4 windows of 16 sources
    vals, idx = distributed_uniwalk_simrank(
        g, mesh, cfg, key=jax.random.key(1),
        max_walk_ints=16 * 200 * 5,
    )
    assert vals.shape == (64, 5)
    assert (vals >= 0).all() and np.isfinite(vals).all()
    # every returned neighbour must be a real positive-sim candidate
    assert ((idx >= -1) & (idx < 64)).all()


def test_wire_packed_exchange_matches_unpacked():
    """int8/int16 wire formats route the same values as int32 buckets
    (BatchSingleWalkVertex_Byte.java:38-51 semantics: packing changes
    bytes on the wire, never the message content)."""
    from graphtpu.dist.frontier import narrowest_int_dtype

    mesh = make_1d_mesh(4)
    n_dev, per = 4, 8

    def run_with(wire):
        @partial(
            shard_map, mesh=mesh, in_specs=(P("data"),), out_specs=P("data")
        )
        def run(x):
            owner = x % n_dev
            (recv,), _ = exchange_by_owner(
                (x,), owner, "data", n_dev, per, wire_dtypes=(wire,)
            )
            return recv[None, :]

        return np.asarray(run(jnp.arange(32, dtype=jnp.int32)))

    base = run_with(None)
    for wd in (jnp.int8, jnp.int16):
        got = run_with(wd)
        assert got.dtype == base.dtype  # widened back after the wire
        np.testing.assert_array_equal(got, base)
    assert narrowest_int_dtype(31) == jnp.int8
    assert narrowest_int_dtype(300) == jnp.int16
    assert narrowest_int_dtype(70000) == jnp.int32


def test_distributed_walks_wire_bytes_halved():
    """The walk superstep ships short-packed buckets: >=2x fewer
    collective bytes than int32, with walks
    unchanged (covered by equality tests above)."""
    from graphtpu.dist.frontier import reset_wire_stats, wire_stats

    g = _medium_random()  # V < 2**15 -> int16 ids on the wire
    mesh = make_1d_mesh(8)
    reset_wire_stats()
    w = np.asarray(distributed_uniform_walks(
        g, n_walkers=128, num_steps=4, key=jax.random.key(1), mesh=mesh
    ))
    st = wire_stats()
    assert st["exchanges"] > 0
    assert st["bytes"] * 2 <= st["bytes_unpacked"], st
    assert (w[:, 0] >= 0).all()
