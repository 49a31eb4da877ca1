"""Exact SimRank on arxiv (V=38,741) — beyond the reference's reach.

The reference runs exact SimRank only up to ~10k vertices (dense
double[V][V] on one JVM, ``SURVEY.md §6``, ``simrank/SimRank.java``); on
arxiv it falls back to MC approximations.  One card holds the dense
problem in bf16: V padded to 38,912 gives 2.9GB per [V, V] buffer;
S' = C P S P^T runs as dense matmuls with f32 accumulation.

Rules this script encodes (see CLAUDE.md):
  * big device arrays (P, S) are passed as jit *arguments* — closure
    capture bakes them into the program as constants;
  * P is densified on device from the padded-neighbour matrix with a
    compare-accumulate loop over the <=116 neighbour slots — no scatters
    (which serialise), no per-element bisection gathers, no multi-GB
    host->device transfer;
  * the diagonal masks are fused iota-compares inside the jitted steps —
    never materialised as a [V, V] buffer;
  * every jit threads a traced operand so the client can't constant-fold
    the [V, V] graph host-side.

Validation: top-k agreement against an independent UniWalk MC estimate on
a source subset (the estimators agree at the same level they do on small
graphs where exact-f32 is available).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import graphtpu
from graphtpu.core.config import UniWalkConfig
from graphtpu.core.graph import padded_neighbors
from graphtpu.kernels.topk import topk_rows
from graphtpu.simrank.uniwalk import uniwalk_simrank

ARXIV = "/root/reference/DeepSim/lshrank_data/realdata/arxiv_author_pub.txt"
V_PAD = 38912  # 304 * 128
TR = 2048      # row-tile height for the on-device P build


def _diag_mask(n, row0=0):
    r = jax.lax.broadcasted_iota(jnp.int32, (n, V_PAD), 0) + row0
    c = jax.lax.broadcasted_iota(jnp.int32, (n, V_PAD), 1)
    return r == c


def main(iterations=5, c=0.6, topk=20, n_check=128):
    g = graphtpu.read_edgelist_graph(ARXIV, n_nodes=V_PAD)
    dmax = int(g.max_degree)
    print(f"graph: V={g.n_nodes} slots={g.n_edges} maxdeg={dmax}", flush=True)

    nbrs, _ = padded_neighbors(g)            # [V, dmax] int32, ~18MB upload
    inv_deg = (1.0 / jnp.maximum(g.deg, 1).astype(jnp.float32)).astype(
        jnp.bfloat16
    )

    @jax.jit
    def p_tile(nbrs_all, inv_deg_all, row0):
        nb = jax.lax.dynamic_slice(nbrs_all, (row0, 0), (TR, dmax))
        cols = jax.lax.iota(jnp.int32, V_PAD)

        def body(d, acc):
            return acc | (nb[:, d][:, None] == cols[None, :])

        exists = jax.lax.fori_loop(
            0, dmax, body, jnp.zeros((TR, V_PAD), bool)
        )
        dslice = jax.lax.dynamic_slice(inv_deg_all, (row0,), (TR,))
        return jnp.where(exists, dslice[:, None], jnp.bfloat16(0.0))

    @jax.jit
    def put_tile(pbuf, tile, row0):
        return jax.lax.dynamic_update_slice(pbuf, tile, (row0, 0))

    t0 = time.time()
    p = jnp.zeros((V_PAD, V_PAD), jnp.bfloat16)
    for row0 in range(0, V_PAD, TR):
        p = put_tile(p, p_tile(nbrs, inv_deg, jnp.int32(row0)), jnp.int32(row0))
    p.block_until_ready()
    print(f"P built on device (compare tiles): {time.time() - t0:.1f}s", flush=True)

    @jax.jit
    def init_s(one):
        return jnp.where(_diag_mask(V_PAD), one, jnp.bfloat16(0.0))

    @jax.jit
    def one_iter(s, p):
        # the matmul accumulates in f32; bf16 preferred output avoids any
        # full-size f32 buffer (device memory holds only bf16 [V, V] arrays)
        t = jax.lax.dot_general(
            s, p, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.bfloat16,
        )  # s @ p.T
        s2 = jnp.bfloat16(c) * jax.lax.dot(
            p, t, preferred_element_type=jnp.bfloat16
        )
        return jnp.where(_diag_mask(V_PAD), jnp.bfloat16(1.0), s2)

    s = init_s(jnp.bfloat16(1.0))
    t0 = time.time()
    s = one_iter(s, p)
    s.block_until_ready()
    print(f"iter 1 (compile): {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    for _ in range(iterations - 1):
        s = one_iter(s, p)
    s.block_until_ready()
    per = (time.time() - t0) / max(iterations - 1, 1)
    print(f"per-iter: {per:.2f}s ({2 * 2 * V_PAD**3 / per / 1e12:.1f} Tflop/s eff)", flush=True)

    # zero the diagonal (SimRank.java:62-65) and extract the check rows
    @jax.jit
    def head_rows(s, zero):
        head = jax.lax.dynamic_slice(s, (0, 0), (n_check, V_PAD))
        return jnp.where(_diag_mask(n_check), zero, head).astype(jnp.float32)

    rows = head_rows(s, jnp.bfloat16(0.0))
    vals, idx = topk_rows(rows, topk)
    uw_vals, uw_idx = uniwalk_simrank(
        g,
        UniWalkConfig(sample=3000, step=iterations, topk=topk, source_tile=64),
        key=jax.random.key(0),
        sources=np.arange(n_check),
    )
    vals, idx = np.asarray(vals), np.asarray(idx)
    agree = []
    for r in range(n_check):
        a = set(idx[r][vals[r] > 0].tolist())
        b = set(uw_idx[r][uw_vals[r] > 0].tolist())
        if a:
            agree.append(len(a & b) / len(a))
    print(f"exact(bf16) vs uniwalk top-{topk} agreement on {n_check} sources: "
          f"{np.mean(agree):.3f}", flush=True)
    np.save("/tmp/arxiv_top20_idx.npy", idx)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
