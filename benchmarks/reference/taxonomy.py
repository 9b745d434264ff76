"""The taxonomy's Euler intervals, depths and LCA (SEMANTICS.md §6), from
its parent array alone."""
from __future__ import annotations

import numpy as np


class Tree:
    """Taxa 1..T under root 1 (``parent[1] == 1``); 0 is unclassified.
    A DFS from the root, children in ascending id order, stamps ``tin`` and
    ``tout`` (subtree of t = [tin[t], tout[t])); taxon 0 gets the empty
    interval [-1, -1)."""

    def __init__(self, parent):
        parent = np.asarray(parent, dtype=np.int64)
        T = parent.shape[0] - 1
        if T < 1 or parent[1] != 1:
            raise ValueError("the root must be taxon 1, its own parent")
        self.parent = parent.copy()
        self.parent[0] = 0
        kids = parent[2:]
        order = np.argsort(kids, kind="stable")      # by parent, then id
        child = order + 2
        first = np.searchsorted(kids[order], np.arange(T + 2))
        tin = np.full(T + 1, -1, np.int64)
        tout = np.full(T + 1, -1, np.int64)
        depth = np.zeros(T + 1, np.int64)
        timer = 0
        stack = [(1, first[1])]
        tin[1] = timer
        timer += 1
        while stack:
            node, cur = stack[-1]
            if cur < first[node + 1]:
                stack[-1] = (node, cur + 1)
                c = int(child[cur])
                depth[c] = depth[node] + 1
                tin[c] = timer
                timer += 1
                stack.append((c, first[c]))
            else:
                tout[node] = timer
                stack.pop()
        if timer != T:
            raise ValueError(f"{T - timer} taxa are not under the root")
        self.tin, self.tout, self.depth = tin, tout, depth

    @property
    def num_taxa(self) -> int:
        return self.parent.shape[0] - 1

    def is_ancestor_or_self(self, a, t) -> np.ndarray:
        """tin[a] <= tin[t] < tout[a], elementwise (broadcasting)."""
        a, t = np.asarray(a), np.asarray(t)
        return (self.tin[a] <= self.tin[t]) & (self.tin[t] < self.tout[a])

    def lca(self, a, b) -> np.ndarray:
        """Elementwise LCA of two taxon arrays, 0 acting as identity: the
        deeper side walks up to the other's depth, then both walk up until
        they meet."""
        a = np.asarray(a, dtype=np.int64).copy()
        b = np.asarray(b, dtype=np.int64).copy()
        a, b = np.broadcast_arrays(a, b)
        a, b = a.copy(), b.copy()
        za, zb = a == 0, b == 0
        a[za] = b[za]
        b[zb] = a[zb]
        while True:
            deeper = self.depth[a] > self.depth[b]
            if not deeper.any():
                break
            a = np.where(deeper, self.parent[a], a)
        while True:
            deeper = self.depth[b] > self.depth[a]
            if not deeper.any():
                break
            b = np.where(deeper, self.parent[b], b)
        while True:
            diff = a != b
            if not diff.any():
                return a
            a = np.where(diff, self.parent[a], a)
            b = np.where(diff, self.parent[b], b)
