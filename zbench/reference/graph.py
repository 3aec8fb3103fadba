"""Vectorised relation primitives of the plain references: sorted pair sets
and adjacency lists over object indices, NumPy only."""

from __future__ import annotations

import numpy as np


class Edges:
    """The pairs (a, b) of one relation, as sorted keys and an adjacency
    list from a to b (duplicate pairs are harmless)."""

    def __init__(self, a, b, n_a: int, n_b: int) -> None:
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        order = np.lexsort((b, a))
        self.a, self.b = a[order], b[order]
        self.n_b = int(n_b)
        self.keys = self.a * self.n_b + self.b
        self.indptr = np.searchsorted(self.a, np.arange(int(n_a) + 1))

    def has(self, a, b) -> np.ndarray:
        """Whether each (a[i], b[i]) is a pair of the relation."""
        k = np.asarray(a, np.int64) * self.n_b + np.asarray(b, np.int64)
        if self.keys.shape[0] == 0:
            return np.zeros(k.shape, bool)
        pos = np.minimum(np.searchsorted(self.keys, k), self.keys.shape[0] - 1)
        return self.keys[pos] == k

    def expand(self, a):
        """(row, b): for each i, one row per b with (a[i], b) a pair."""
        a = np.asarray(a, np.int64)
        starts, ends = self.indptr[a], self.indptr[a + 1]
        counts = ends - starts
        row = np.repeat(np.arange(a.shape[0]), counts)
        first = np.repeat(np.cumsum(counts) - counts, counts)
        pos = np.arange(row.shape[0]) - first + np.repeat(starts, counts)
        return row, self.b[pos]

    def reverse(self, n_a: int) -> "Edges":
        return Edges(self.b, self.a, self.n_b, n_a)


def any_by(row, hit, n: int) -> np.ndarray:
    """out[i] = any(hit[row == i])."""
    out = np.zeros(n, bool)
    out[np.asarray(row)[np.asarray(hit, bool)]] = True
    return out


def closure(row, node, step: Edges, n_nodes: int):
    """The least fixpoint of the pairs (row, node) under node -> step(node):
    every (row, x) reachable from a start pair.  Unique pairs, any order."""
    seen = np.unique(np.asarray(row, np.int64) * n_nodes + np.asarray(node, np.int64))
    frontier = seen
    while frontier.shape[0]:
        r, x = frontier // n_nodes, frontier % n_nodes
        i, y = step.expand(x)
        nxt = np.unique(r[i] * n_nodes + y)
        frontier = nxt[~np.isin(nxt, seen, assume_unique=True)]
        seen = np.union1d(seen, frontier)
    return seen // n_nodes, seen % n_nodes
