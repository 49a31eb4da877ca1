"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on the CPU with
``xla_force_host_platform_device_count``; the same paths run on real
cards through ``chip_smoke.py --multi``.  These env vars must be set
before jax initialises.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU; here they skip, and
``chip_smoke.py`` covers the same code on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Pin the platform through the config API (before first backend use), so
# the tests run on the CPU whatever accelerator plugin is installed.
jax.config.update("jax_platforms", "cpu")
# the entry points (graphtpu.cli.main) turn on the persistent compile
# cache; tests compile afresh and write no cache into the checkout
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

import graphtpu  # noqa: E402  (trigger registry setup)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips when JAX finds none"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: covered on the card by chip_smoke.py")


@pytest.fixture(scope="session")
def karate():
    """The karate-club graph (node2vec/graph/karate.edgelist, ids 1..34)."""
    path = "/root/reference/node2vec/graph/karate.edgelist"
    if os.path.exists(path):
        return graphtpu.read_edgelist_graph(path, n_nodes=35)
    # fall back to a deterministic random graph of similar size, on the
    # file's ids 1..34 (node 0 stays isolated, as with the real file)
    rng = np.random.default_rng(0)
    edges = rng.integers(1, 35, size=(78, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return graphtpu.build_graph(edges, n_nodes=35)


@pytest.fixture(scope="session")
def ring16():
    """A 16-node ring: every node has degree 2; easy closed forms."""
    edges = np.array([[i, (i + 1) % 16] for i in range(16)])
    return graphtpu.build_graph(edges, n_nodes=16)


@pytest.fixture(scope="session")
def small_random():
    """Deterministic 64-node random graph, no isolated nodes."""
    rng = np.random.default_rng(42)
    edges = rng.integers(0, 64, size=(400, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate([edges, np.stack([np.arange(64), (np.arange(64) + 1) % 64], 1)])
    return graphtpu.build_graph(edges, n_nodes=64)
