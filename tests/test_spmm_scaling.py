"""Per-device memory ceiling of the sharded SpMM SimRank, asserted from
the COMPILED executable: XLA's buffer assignment must
show O(V^2/n_dev) argument/output blocks and a bounded ring-buffer
constant — not just source-level sharding annotations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from graphtpu.core.config import SimRankConfig


@pytest.fixture(scope="module")
def mesh8():
    from graphtpu.dist.mesh import make_1d_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_1d_mesh(8)


def test_compiled_per_device_peak_is_sharded(mesh8):
    import graphtpu
    from graphtpu.dist.spmm_sharded import make_sharded_iter

    v, n_dev = 2048, 8
    rng = np.random.default_rng(0)
    e = 8 * v
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)
    g = graphtpu.build_graph(np.concatenate([edges, ring]), n_nodes=v)

    plan, vv, init, run_n, zero_diag = make_sharded_iter(
        g, mesh8, SimRankConfig(iterations=1)
    )
    lw = plan.levels + plan.weights
    s = init(jnp.zeros((n_dev,), jnp.float32))
    compiled = run_n.lower(s, 2, *lw).compile()
    ma = compiled.memory_analysis()
    share = vv * (vv // n_dev) * 4
    full = vv * vv * 4
    peak = (
        ma.argument_size_in_bytes
        + ma.output_size_in_bytes
        + ma.temp_size_in_bytes
    )
    # arguments + output are per-device shares (plus the O(E/n_dev)
    # plan); temps are the ring double-buffers — constant x share.
    # A replicated-iterate design would need >= 2 x full per device.
    assert ma.argument_size_in_bytes < 1.5 * share
    assert ma.output_size_in_bytes < 1.2 * share
    assert peak < 6 * share + (16 << 20), (peak, share)
    assert peak < full, (peak, full)

    # and the result really is column-sharded on the mesh
    s = run_n(s, 2, *lw)
    shapes = {tuple(sh.data.shape) for sh in s.addressable_shards}
    assert shapes == {(vv, vv // n_dev)}


def test_sharded_bf16_iterates(mesh8):
    """bf16-iterate mode: halved ring payloads + per-device memory,
    f32 tree accumulation; ranking-grade parity with the f32 run."""
    import graphtpu
    from graphtpu.dist.spmm_sharded import sharded_simrank_spmm

    rng = np.random.default_rng(1)
    v = 256
    edges = rng.integers(0, v, size=(2000, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)
    g = graphtpu.build_graph(np.concatenate([edges, ring]), n_nodes=v)

    f32 = np.asarray(
        sharded_simrank_spmm(g, mesh8, SimRankConfig(iterations=3))
    )
    s16 = sharded_simrank_spmm(
        g, mesh8, SimRankConfig(iterations=3), dtype=jnp.bfloat16
    )
    assert s16.dtype == jnp.bfloat16
    b16 = np.asarray(s16.astype(jnp.float32))
    assert np.abs(b16 - f32).max() < 2e-2
    # top-10 agreement per sampled row
    agree = []
    for r in range(0, v, 11):
        t1 = set(np.argsort(-f32[r])[:10])
        t2 = set(np.argsort(-b16[r])[:10])
        agree.append(len(t1 & t2) / 10)
    assert np.mean(agree) >= 0.9, np.mean(agree)
