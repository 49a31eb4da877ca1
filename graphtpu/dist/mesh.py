"""Device-mesh construction.

The reference's distribution substrate is Giraph BSP over Hadoop RPC +
ZooKeeper (``TopSimAll/.classpath:17-29``).  The accelerator substrate is a
``jax.sharding.Mesh`` over the device interconnect with XLA collectives; a "superstep" is
one jitted collective step (SURVEY.md §2.3).

Axes:
  * ``data``  — walker/batch parallelism (the Giraph vertex-partition axis)
  * ``model`` — embedding-table row sharding (the TP analog for [V, D])
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def device_count() -> int:
    return len(jax.devices())


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
    model_parallel: int = 1,
) -> Mesh:
    """A (data, model) mesh over the first n_devices devices.

    ``model_parallel`` devices on the model axis (must divide n)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    assert n % model_parallel == 0, (n, model_parallel)
    arr = np.asarray(devs).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, axis_names=tuple(axis_names))


def make_1d_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), axis_names=(axis,))
