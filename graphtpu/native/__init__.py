"""Native (C++) host-side components, loaded via ctypes.

The reference's native-performance pieces are the JVM kernels and gensim's C
inner loop; our compute path is JAX on the accelerator, and the host-side runtime
(IO parsing, CSR sharding) gets C++ equivalents here.  Build with::

    make -C graphtpu/native

Everything degrades gracefully to numpy when the shared library is absent.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    sopath = os.path.join(os.path.dirname(__file__), "libgraphtpu_native.so")
    if not os.path.exists(sopath):
        return None
    try:
        lib = ctypes.CDLL(sopath)
        lib.gt_parse_edgelist.restype = ctypes.c_longlong
        lib.gt_parse_edgelist.argtypes = [
            ctypes.c_char_p,      # path
            ctypes.c_char,        # delimiter (0 = whitespace)
            ctypes.POINTER(ctypes.c_longlong),  # out: src
            ctypes.POINTER(ctypes.c_longlong),  # out: dst
            ctypes.POINTER(ctypes.c_float),     # out: weights
            ctypes.POINTER(ctypes.c_int),       # out: has_weights
            ctypes.c_longlong,    # capacity
        ]
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
        return _LIB
    # resolve newer symbols independently: a stale .so built before
    # generate.cpp must only lose gt_generate_graph, not the whole library
    try:
        lib.gt_generate_graph.restype = ctypes.c_longlong
        lib.gt_generate_graph.argtypes = [
            ctypes.c_char_p,      # path
            ctypes.c_longlong,    # n_left
            ctypes.c_longlong,    # n_right
            ctypes.c_longlong,    # target edges
            ctypes.c_int,         # mode: 0 bipartite, 1 undirected, 2 directed
            ctypes.c_ulonglong,   # seed
            ctypes.c_int,         # threads (0 = hw)
        ]
        lib._gt_has_generate = True
    except AttributeError:
        lib._gt_has_generate = False
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_parse_edgelist(
    path: str, delimiter: Optional[str]
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Parse with the C++ tokenizer; None if the library isn't built."""
    lib = _load()
    if lib is None:
        return None
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        return None
    # upper bound on line count: one edge needs >= 4 bytes ("a b\n")
    cap = max(nbytes // 4 + 16, 16)
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    wts = np.empty(cap, dtype=np.float32)
    has_w = ctypes.c_int(0)
    delim = (delimiter or "\0")[0].encode() if delimiter else b"\0"
    n = lib.gt_parse_edgelist(
        path.encode(),
        ctypes.c_char(delim),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(has_w),
        cap,
    )
    if n < 0:
        return None
    edges = np.stack([src[:n], dst[:n]], axis=1)
    return edges, (wts[:n].copy() if has_w.value else None)


_GEN_MODES = {"bipartite": 0, "uniform": 1, "directed": 2}


def native_generate_graph(
    path: str,
    mode: str,
    n_left: int,
    n_right: int = 0,
    target_edges: int = 0,
    seed: int = 0,
    threads: int = 0,
) -> Optional[int]:
    """Stream `target_edges` Bloom-deduped random edges to `path` with the
    multithreaded C++ generator (GraphGeneratorBf's role); None if the
    library isn't built, -1-as-None on invalid arguments."""
    lib = _load()
    if lib is None or not getattr(lib, "_gt_has_generate", False):
        return None
    n = lib.gt_generate_graph(
        path.encode(), n_left, n_right, target_edges,
        _GEN_MODES[mode], seed, threads,
    )
    return None if n < 0 else int(n)
