"""Host conversions between the adjacency layouts of a point cloud.

Counterpart of the host helpers of `fusion3dseg_tpu/ops/neighbors.py`:
the reference's `adj.pkl` artifact is an object array of per-point
neighbour-index arrays (ragged lists); the instance split takes them as
CSR (offsets, flat) for the native union-find or as a fixed-degree
[N, K] table (-1 padded). The device radius graph of the reference waits
for the post-processing slice; the full radius lists come from
`io/native.radius_graph_lists`.
"""

from __future__ import annotations

import numpy as np


def adjacency_to_lists(adj) -> np.ndarray:
    """[N, K] padded adjacency -> object array of int64 index arrays (the
    `adj.pkl` layout)."""
    adj = np.asarray(adj)
    out = np.empty(len(adj), dtype=object)
    for i, row in enumerate(adj):
        out[i] = row[row >= 0].astype(np.int64)
    return out


def lists_to_adjacency(lists, k: int) -> np.ndarray:
    """Ragged lists -> fixed-degree [N, k] int32, each row cut to its first
    k neighbours."""
    n = len(lists)
    adj = np.full((n, k), -1, np.int32)
    for i, row in enumerate(lists):
        row = np.asarray(list(row), np.int32)[:k]
        adj[i, : len(row)] = row
    return adj


def lists_to_csr(lists):
    """Ragged lists -> CSR (offsets [N+1] int32, flat int32), by one
    concatenate."""
    lengths = np.fromiter((len(r) for r in lists), np.int64, count=len(lists))
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = (np.concatenate([np.asarray(r, np.int32) for r in lists])
            if len(lists) else np.empty(0, np.int32))
    if offsets[-1] >= np.iinfo(np.int32).max:
        raise ValueError("edge count exceeds int32 CSR offsets; split the graph")
    return offsets.astype(np.int32), flat.astype(np.int32)


def csr_to_adjacency(offsets, flat) -> np.ndarray:
    """CSR -> fixed-degree [N, max degree] int32 (-1 padded)."""
    offsets = np.asarray(offsets, np.int64)
    flat = np.asarray(flat, np.int32)
    n = len(offsets) - 1
    lengths = np.diff(offsets)
    k = int(lengths.max()) if n else 0
    adj = np.full((n, max(k, 1)), -1, np.int32)
    rows = np.repeat(np.arange(n), lengths)
    cols = np.arange(len(flat)) - np.repeat(offsets[:-1], lengths)
    adj[rows, cols] = flat
    return adj
