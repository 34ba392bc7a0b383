"""Pose-graph utilities: the Kruskal maximum spanning tree over the
covisibility graph that picks which two-pose edges marginalisation creates
(counterpart of ``okvis2x_tpu/graph/posegraph.py::max_spanning_tree``; the
pose-graph optimiser is not part of the port yet)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class DisjointSet:
    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, x: int) -> int:
        while self.parent.setdefault(x, x) != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def max_spanning_tree(
    edges: Sequence[Tuple[int, int, float]]
) -> List[Tuple[int, int, float]]:
    """Kruskal MST maximising total weight; edges (i, j, weight)."""
    ds = DisjointSet()
    out = []
    for i, j, w in sorted(edges, key=lambda e: -e[2]):
        if ds.union(i, j):
            out.append((i, j, w))
    return out
