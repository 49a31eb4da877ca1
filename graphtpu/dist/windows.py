"""Batched source windows with streamed flush + checkpoint/resume.

The reference bounds memory by processing sources in windows: a Giraph
MasterCompute broadcasts a [VID_LOWER, VID_UPPER] window every CYCLE
supersteps (``giraph/SingleWalkMasterCompute.java:29-35``); in-window
vertices run their walks, flush their top-k straight to per-partition HDFS
files and vote to halt (``giraph/BatchSingleWalkVertex.java:108-133``).
Fault tolerance is "resume at the last completed window" (SURVEY.md §5).

Device form: the device loop processes one window per pass, streams its top-k
to a per-window part file, and persists a JSON cursor.  Killing the job at
any point loses at most one window.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import jax
import numpy as np

from graphtpu.io.simfile import write_topk_files
from graphtpu.utils.metrics import StepMetrics

TileFn = Callable[[np.ndarray, jax.Array], Tuple[np.ndarray, np.ndarray]]


def windowed_topk_sweep(
    compute_tile: TileFn,
    n_sources: int,
    out_dir: str,
    window: int = 40000,
    key: Optional[jax.Array] = None,
    resume: bool = True,
    metrics: Optional[StepMetrics] = None,
    precision: int = 6,
) -> str:
    """Run ``compute_tile(sources, key) -> (vals, idx)`` over source
    windows; returns the directory holding part files + checkpoint.

    ``window`` defaults to the flagship run's BATCH=40000
    (``CombineBatchSingleWalkVertexReuse.java:41``).
    """
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "checkpoint.json")
    start = 0
    if resume and os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            start = json.load(f)["next_window_start"]
    if key is None:
        key = jax.random.key(0)

    lo = start
    while lo < n_sources:
        hi = min(lo + window, n_sources)
        sources = np.arange(lo, hi, dtype=np.int32)
        ctx = metrics.step(f"window[{lo}:{hi}]") if metrics else None
        if ctx:
            ctx.__enter__()
        vals, idx = compute_tile(sources, jax.random.fold_in(key, lo))
        part = os.path.join(out_dir, f"part-{lo:010d}")
        write_topk_files(part, idx, vals, sources=sources, precision=precision)
        # window complete -> durable cursor (the voteToHalt + flush analog)
        tmp = ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"next_window_start": hi, "n_sources": n_sources}, f)
        os.replace(tmp, ckpt_path)
        if ctx:
            ctx.__exit__(None, None, None)
        lo = hi
    return out_dir


def read_sweep_results(out_dir: str):
    """Merge all part .sim.txt files into one {source: [(nbr, val)]} dict."""
    from graphtpu.io.simfile import read_sim_file

    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("part-") and name.endswith(".sim.txt"):
            out.update(read_sim_file(os.path.join(out_dir, name)))
    return out
