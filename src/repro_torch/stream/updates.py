"""Edge update batches for evolving graphs.

An `UpdateBatch` is an ordered list of edge operations against the shared
CSR — the RAW graph, before any view's normalization/symmetrization:

  INSERT (u, v, w)  upsert: create the edge, or replace its weight if it
                    already exists (reweight == insert of an existing
                    edge).  In-batch duplicates of the same (u, v) keep
                    the MIN weight, matching CSRGraph.from_edges dedupe.
  DELETE (u, v)     remove the edge if present (no-op otherwise).

Ops apply IN ORDER: a delete followed by an insert of the same edge
re-creates it.  `apply_to_csr` is the exact host-side application — the
source of truth every view compacts against, so compaction is
bit-identical to a from-scratch build on the updated CSR by construction.

Vertices are fixed for the session's lifetime (n never changes): block
ids stay view-agnostic and job state shapes stay stable, so an update
batch never changes the shape of a session's job state.

Host numpy, copied from the reference (`repro.stream.updates`): the same
batch gives the same CSR byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.structure import CSRGraph

INSERT, DELETE = 0, 1


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """One batch of edge operations (applied atomically between supersteps)."""

    src: np.ndarray   # [E] int64
    dst: np.ndarray   # [E] int64
    w: np.ndarray     # [E] float32 (ignored for deletes)
    op: np.ndarray    # [E] int8, INSERT or DELETE

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int64))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int64))
        object.__setattr__(self, "w", np.asarray(self.w, np.float32))
        object.__setattr__(self, "op", np.asarray(self.op, np.int8))
        if not (len(self.src) == len(self.dst) == len(self.w)
                == len(self.op)):
            raise ValueError("ragged update batch")

    def __len__(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_inserts(self) -> int:
        return int((self.op == INSERT).sum())

    @property
    def num_deletes(self) -> int:
        return int((self.op == DELETE).sum())

    @staticmethod
    def inserts(src, dst, w=None) -> "UpdateBatch":
        src = np.asarray(src, np.int64)
        w = np.ones(len(src), np.float32) if w is None else w
        return UpdateBatch(src, np.asarray(dst, np.int64), w,
                           np.full(len(src), INSERT, np.int8))

    @staticmethod
    def deletes(src, dst) -> "UpdateBatch":
        src = np.asarray(src, np.int64)
        return UpdateBatch(src, np.asarray(dst, np.int64),
                           np.zeros(len(src), np.float32),
                           np.full(len(src), DELETE, np.int8))

    @staticmethod
    def concat(batches: Sequence["UpdateBatch"]) -> "UpdateBatch":
        return UpdateBatch(
            np.concatenate([b.src for b in batches]) if batches else
            np.zeros(0, np.int64),
            np.concatenate([b.dst for b in batches]) if batches else
            np.zeros(0, np.int64),
            np.concatenate([b.w for b in batches]) if batches else
            np.zeros(0, np.float32),
            np.concatenate([b.op for b in batches]) if batches else
            np.zeros(0, np.int8))


def _edge_dict(csr: CSRGraph) -> dict:
    """{(u, v): w} of the whole CSR (host; fine at repo scales)."""
    src = np.repeat(np.arange(csr.n, dtype=np.int64), csr.out_degree)
    return {(int(u), int(v)): float(w)
            for u, v, w in zip(src, csr.indices, csr.weights)}


def apply_to_csr(csr: CSRGraph, batch: UpdateBatch) -> CSRGraph:
    """Exact, deterministic application of `batch` to a CSR (new object).

    In-batch duplicate INSERTs of one (u, v) keep the min weight (the
    from_edges dedupe rule); ops otherwise apply in order."""
    n = csr.n
    if len(batch) and (batch.src.min() < 0 or batch.src.max() >= n
                       or batch.dst.min() < 0 or batch.dst.max() >= n):
        raise ValueError(f"update endpoints out of range for n={n}")
    edges = _edge_dict(csr)
    seen_insert = set()
    for u, v, w, op in zip(batch.src, batch.dst, batch.w, batch.op):
        key = (int(u), int(v))
        if op == DELETE:
            edges.pop(key, None)
            seen_insert.discard(key)
        else:
            w = float(w)
            if key in seen_insert:     # in-batch duplicate: min-weight
                edges[key] = min(edges[key], w)
            else:
                edges[key] = w         # upsert (reweight == insert)
                seen_insert.add(key)
    if not edges:
        return CSRGraph.from_edges(n, np.zeros(0, np.int64),
                                   np.zeros(0, np.int64))
    items = np.array(sorted(edges), dtype=np.int64)
    w = np.array([edges[(int(u), int(v))] for u, v in items],
                 dtype=np.float32)
    return CSRGraph.from_edges(n, items[:, 0], items[:, 1], w)
