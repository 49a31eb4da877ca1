"""BlogCatalog-style ``.mat`` loading.

The reference evaluation loads ``blogcatalog.mat`` with scipy and reads the
``network`` (sparse adjacency) and ``group`` (sparse multi-label matrix)
variables (``node2vec/src/classify.py:184-190``).  Nodes in the `.emb` file
are labelled 1..N while the mat rows are 0-based (``classify.py:192``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_blogcatalog(path: str) -> Tuple["sp.spmatrix", "sp.spmatrix"]:
    """Return (network, group) sparse matrices."""
    from scipy.io import loadmat  # off the main path: .mat inputs only

    mat = loadmat(path)
    return mat["network"], mat["group"]


def labels_to_lists(group: "sp.spmatrix"):
    """[{label indices} per node] from the sparse multi-label matrix, the way
    ``classify.py:216-231`` builds y_train/y_test."""
    coo = group.tocoo()
    out = [[] for _ in range(group.shape[0])]
    for i, j in zip(coo.row, coo.col):
        out[i].append(int(j))
    return out
