"""Pareto dominance, non-dominated sorting, and crowding-distance
diversity (NSGA-II style, O(n^2)).

All functions take vectors in *canonical maximization form* (see
:meth:`repro.dse.objectives.Objectives.canonical`): every component is
better when larger. Campaign sizes are hundreds to a few thousand designs,
so the simple fast-non-dominated-sort is plenty.

:func:`crowding_distance` and :func:`select_diverse` implement NSGA-II's
diversity preservation (Deb et al., 2002): when a frontier must be
truncated to *k* designs, keep the ones whose objective-space neighbors
are farthest apart, so the survivors SPREAD across the trade-off surface
instead of clumping around one region of it.
"""
from __future__ import annotations

import math
from typing import Sequence, TypeVar

import numpy as np

T = TypeVar("T")

Vector = Sequence[float]


def dominates(a: Vector, b: Vector) -> bool:
    """True iff ``a`` is >= ``b`` everywhere and > somewhere."""
    if len(a) != len(b):
        raise ValueError(f"objective arity mismatch: {len(a)} vs {len(b)}")
    better = False
    for ai, bi in zip(a, b):
        if ai < bi:
            return False
        if ai > bi:
            better = True
    return better


def dominance_split(mat: np.ndarray, v: np.ndarray,
                    ) -> tuple[bool, np.ndarray]:
    """One vector against a set, vectorized: ``(dominated, dominates)``
    where ``dominated`` says some row of ``mat`` strictly dominates ``v``
    and ``dominates`` masks the rows ``v`` strictly dominates. The
    incremental frontier (:mod:`repro.dse.frontier`) calls this once per
    insert, so it is the O(front) inner loop of million-record streaming
    — numpy, not the scalar :func:`dominates`."""
    if mat.size == 0:
        return False, np.zeros(0, dtype=bool)
    ge = mat >= v
    gt = mat > v
    dominated = bool((ge.all(axis=1) & gt.any(axis=1)).any())
    dominates_mask = (~gt).all(axis=1) & (~ge).any(axis=1)
    return dominated, dominates_mask


def non_dominated(vectors: Sequence[Vector]) -> list[int]:
    """Indices of the first Pareto front, in input order. Duplicate vectors
    all survive (none strictly dominates its copies)."""
    out = []
    for i, v in enumerate(vectors):
        if not any(dominates(u, v) for j, u in enumerate(vectors) if j != i):
            out.append(i)
    return out


def nondominated_sort(vectors: Sequence[Vector]) -> list[list[int]]:
    """Successive Pareto fronts: front 0 is non-dominated, front k is
    non-dominated once fronts < k are removed. Every index appears in
    exactly one front."""
    remaining = list(range(len(vectors)))
    fronts: list[list[int]] = []
    while remaining:
        sub = [vectors[i] for i in remaining]
        keep = set(non_dominated(sub))
        front = [remaining[j] for j in range(len(remaining)) if j in keep]
        fronts.append(front)
        remaining = [remaining[j] for j in range(len(remaining))
                     if j not in keep]
    return fronts


def pareto_front(items: Sequence[T], vectors: Sequence[Vector]) -> list[T]:
    """The items whose vectors sit on the first front."""
    if len(items) != len(vectors):
        raise ValueError("items/vectors length mismatch")
    return [items[i] for i in non_dominated(vectors)]


def crowding_distance(vectors: Sequence[Vector]) -> list[float]:
    """NSGA-II crowding distance of each vector within its set.

    Per objective, vectors are sorted and each interior one is credited
    the (normalized) gap between its two neighbors; boundary vectors get
    ``inf`` so extremes always survive truncation. Larger distance ==
    lonelier == more diverse. Degenerate objectives (all values equal)
    contribute nothing.
    """
    n = len(vectors)
    if n == 0:
        return []
    if n == 1:
        return [math.inf]
    dist = [0.0] * n
    for d in range(len(vectors[0])):
        order = sorted(range(n), key=lambda i: vectors[i][d])
        lo, hi = vectors[order[0]][d], vectors[order[-1]][d]
        if hi == lo:
            continue  # degenerate objective: no extremes, no gaps
        dist[order[0]] = dist[order[-1]] = math.inf
        for j in range(1, n - 1):
            if dist[order[j]] != math.inf:
                dist[order[j]] += ((vectors[order[j + 1]][d]
                                    - vectors[order[j - 1]][d]) / (hi - lo))
    return dist


def diverse_front(vectors: Sequence[Vector],
                  k: int | None = None) -> list[int]:
    """Indices of the FIRST front only, ordered by crowding distance
    (extremes first, clumps thinned), optionally truncated to ``k``.

    This is the one frontier read-off every consumer wants — per-backend
    report tables, the CLI dump, and the cross-backend frontier over the
    normalized objective schema — as opposed to :func:`select_diverse`,
    which tops up from later fronts to fill ``k``.
    """
    idx = non_dominated(vectors)
    sub = [vectors[i] for i in idx]
    order = select_diverse(sub, len(sub) if k is None or k <= 0 else k)
    return [idx[j] for j in order]


def select_diverse(vectors: Sequence[Vector], k: int) -> list[int]:
    """Up to ``k`` indices by NSGA-II ranking: whole fronts in order, the
    last partially-admitted front truncated to its most-spread members
    (rank ties broken by crowding distance, then by input order for
    determinism). With ``k >= len(vectors)`` this is a diversity-sorted
    permutation of everything."""
    if k <= 0:
        return []
    out: list[int] = []
    for front in nondominated_sort(vectors):
        cd = crowding_distance([vectors[i] for i in front])
        by_spread = sorted(range(len(front)), key=lambda j: (-cd[j], front[j]))
        for j in by_spread:
            if len(out) >= k:
                return out
            out.append(front[j])
    return out
