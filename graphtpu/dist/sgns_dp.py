"""Sharded SGNS training step — the accelerator replacement for hogwild.

The reference trains SGNS with 8 asynchronous hogwild threads inside
gensim (``node2vec/src/main.py:97``).  The accelerator mapping (SURVEY.md
§2.3) is synchronous data parallelism with the embedding tables row-sharded
on a ``model`` axis (tensor-parallel analog for the [V, D] tables) and the
pair batch sharded on ``data``:

  * syn0/syn1:  PartitionSpec('model', None)  — vocab rows over devices
  * batch:      PartitionSpec('data', ...)
  * gradients:  psum over 'data' (XLA inserts it from the shardings)

GSPMD lowers the row gathers to collective lookups and the scatter-adds to
reduce-scatters; no hand-written NCCL-style code, per the scaling-book
recipe: annotate shardings, let XLA place collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtpu.core.config import SGNSConfig
from graphtpu.models.sgns import sgns_loss


def train_sgns_dp(
    walks,
    n_nodes: int,
    mesh: Mesh,
    cfg: SGNSConfig = SGNSConfig(),
    **kw,
):
    """Full multi-device SGNS training run (epochs, dynamic windows,
    subsampling, linear LR, checkpoint/resume) — the end-to-end
    replacement for the reference's complete gensim training flow
    (``node2vec/src/main.py:92-101``), data-parallel over the mesh.

    Thin entry over :func:`graphtpu.models.sgns.train_sgns` with
    ``mesh`` set; returns (syn0, syn1) numpy [V, D].
    """
    from graphtpu.models.sgns import train_sgns

    return train_sgns(walks, n_nodes, cfg, mesh=mesh, **kw)


def make_sgns_train_step(mesh: Mesh, cfg: SGNSConfig, n_nodes: int):
    """Returns (shard_params, train_step).

    ``shard_params((syn0, syn1))`` places tables row-sharded over 'model';
    ``train_step(params, batch, lr)`` runs one synchronous SGD step, where
    ``batch = (centers [B], contexts [B, 2w], mask [B, 2w], negs [B,2w,N])``
    sharded over 'data' on the leading axis.
    """
    param_sharding = NamedSharding(mesh, P("model", None))
    batch_sharding = {
        "centers": NamedSharding(mesh, P("data")),
        "contexts": NamedSharding(mesh, P("data", None)),
        "mask": NamedSharding(mesh, P("data", None)),
        "negs": NamedSharding(mesh, P("data", None, None)),
    }

    def shard_params(params):
        return tuple(jax.device_put(p, param_sharding) for p in params)

    def shard_batch(centers, contexts, mask, negs):
        return (
            jax.device_put(centers, batch_sharding["centers"]),
            jax.device_put(contexts, batch_sharding["contexts"]),
            jax.device_put(mask, batch_sharding["mask"]),
            jax.device_put(negs, batch_sharding["negs"]),
        )

    from graphtpu.models.sgns import sgns_manual_grads

    @partial(
        jax.jit,
        out_shardings=(param_sharding, param_sharding),
        donate_argnums=(0,),
    )
    def train_step(params, centers, contexts, mask, negs, lr):
        (g0, g1), (c0, c1) = sgns_manual_grads(
            params, centers, contexts, mask, negs, n_nodes
        )
        syn0, syn1 = params
        syn0 = syn0 - lr * g0 / jnp.maximum(c0, 1)[:, None]
        syn1 = syn1 - lr * g1 / jnp.maximum(c1, 1)[:, None]
        return syn0, syn1

    return shard_params, shard_batch, train_step
