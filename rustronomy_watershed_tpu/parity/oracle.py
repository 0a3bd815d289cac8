"""Host-side numpy oracle of the reference watershed semantics.

This is a from-scratch, deliberately simple implementation of the behaviour
documented in SURVEY.md §3 (call stack of transform_with_hook,
/root/reference/src/lib.rs:1328-1522) under the pinned deterministic plateau
tie-break (min coloured 4-neighbour label; SURVEY.md Q2/Q9).  It exists only
to cross-check the device engines — it shares no code with them (scalar/NumPy
level loop here vs. lax loops + scatter union-find there).

Semantics replicated:
  * level loop 0..=max, Jacobi colouring sweeps to fixed point,
  * candidates: interior, uncoloured, img <= lvl, >=1 coloured 4-neighbour
    read from the sweep-start snapshot,
  * merging variant: after each level's fixed point, transitively merge all
    4-adjacent differing coloured labels (interior centres), min label wins,
  * seeds painted before level 0, colours 1..K in list order.
"""

from __future__ import annotations

import numpy as np


def oracle_find_local_minima(img) -> list[tuple[int, int]]:
    """Reference find_local_minima (src/lib.rs:1178-1197): interior pixels
    whose eight 8-neighbours are all strictly LESS than the centre (Q1),
    in row-major order."""
    img = np.asarray(img, dtype=np.int64)
    h, w = img.shape
    out = []
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            c = img[y, x]
            neigh = img[y - 1 : y + 2, x - 1 : x + 2].copy()
            neigh[1, 1] = c - 1  # exclude centre
            if np.all(neigh < c):
                out.append((y, x))
    return out


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union_min(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        lo, hi = (ra, rb) if ra < rb else (rb, ra)
        self.parent[hi] = lo


def _flood_level(img: np.ndarray, labels: np.ndarray, lvl: int) -> np.ndarray:
    h, w = img.shape
    while True:
        snapshot = labels.copy()
        updates = []
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                if snapshot[y, x] != 0 or img[y, x] > lvl:
                    continue
                ncols = [
                    snapshot[ny, nx]
                    for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1))
                    if snapshot[ny, nx] != 0
                ]
                if ncols:
                    updates.append(((y, x), min(ncols)))
        if not updates:
            return labels
        for (y, x), col in updates:
            labels[y, x] = col


def _merge_level(labels: np.ndarray, n_labels: int) -> np.ndarray:
    h, w = labels.shape
    uf = _UnionFind(n_labels + 1)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            c = labels[y, x]
            if c == 0:
                continue
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                n = labels[ny, nx]
                if n != 0 and n != c:
                    uf.union_min(c, n)
    lut = np.array([uf.find(i) for i in range(n_labels + 1)], dtype=labels.dtype)
    return lut[labels]


def oracle_transform(
    img,
    seeds,
    max_water_level: int = 254,
    merging: bool = False,
    edge_correction: bool = False,
):
    """Returns (final_labels, per_level_snapshots: list[np.ndarray])."""
    img = np.asarray(img, dtype=np.int64)
    if edge_correction:
        img = np.pad(img, 1, constant_values=0)
    labels = np.zeros(img.shape, dtype=np.int64)
    for col, (y, x) in enumerate(seeds, start=1):
        labels[y, x] = col  # no +1 shift under edge correction (Q7)
    history = []
    for lvl in range(max_water_level + 1):
        labels = _flood_level(img, labels, lvl)
        if merging:
            labels = _merge_level(labels, len(seeds))
        history.append(labels.copy())
    return labels, history
