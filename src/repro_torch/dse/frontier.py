"""Incremental Pareto frontier: an insert-time dominance archive.

The campaign engine historically recomputed frontiers by full O(n^2)
non-dominated sort per report — fine at hundreds of cells, hopeless at
the million-cell scale the ROADMAP targets. :class:`FrontierIndex` keeps
the first front *as records stream in*: each insert is one vectorized
dominance check against the current front (O(front), not O(n)), so a
100k-record store is frontier-ready in a single streaming pass.

Semantics are locked to the :mod:`repro.dse.pareto` oracle and
property-tested against it (``tests/test_frontier.py``):

* the front equals ``non_dominated(current vectors)`` — same members,
  same order (first-appearance key order, the order a JSONL store's
  last-wins dict iterates in);
* duplicate vectors coexist on the front (strict dominance only),
  exactly like the oracle;
* re-inserting an existing key REPLACES its vector (last wins, like a
  store re-run) and repairs the front, resurrecting points the old
  vector had been shadowing;
* :meth:`diverse` returns the front in NSGA-II crowding order —
  bit-compatible with ``pareto.diverse_front`` over the same vectors.

Payloads: each insert may carry an opaque payload (typically the full
store record). Payloads are retained only for CURRENT front members, so
memory stays O(front), not O(records); after a replacement-triggered
repair a resurrected member's payload may be ``None`` (the stream that
dominated it away did not keep it), and consumers fall back to
``store.get(key)``.
"""
from __future__ import annotations

from typing import Any, Hashable, Iterable, Sequence

import numpy as np

from .pareto import crowding_distance, dominance_split

Vector = Sequence[float]


class FrontierIndex:
    """Insert-time dominance archive over keyed objective vectors
    (canonical maximization form, like everything in
    :mod:`repro.dse.pareto`)."""

    def __init__(self, dim: int | None = None):
        self._dim = dim
        #: key -> current vector, in FIRST-APPEARANCE key order (dict
        #: reassignment keeps the slot, mirroring store last-wins).
        self._points: dict[Hashable, tuple] = {}
        self._front: dict[Hashable, tuple] = {}
        self._payloads: dict[Hashable, Any] = {}
        self._mat: np.ndarray | None = None  # cached front matrix
        #: Total insert calls (including rejected and replacement ones).
        self.inserts = 0
        #: Front repairs forced by replacing a front member's vector.
        self.rebuilds = 0

    # -- queries ----------------------------------------------------------

    @property
    def dim(self) -> int | None:
        return self._dim

    def __len__(self) -> int:
        """Number of CURRENT points (last version per key)."""
        return len(self._points)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._points

    def front_size(self) -> int:
        return len(self._front)

    def on_front(self, key: Hashable) -> bool:
        return key in self._front

    def front_keys(self) -> list[Hashable]:
        """Front member keys in first-appearance order — the order the
        ``non_dominated`` oracle would emit over the current points."""
        return list(self._front)

    def front_vectors(self) -> list[tuple]:
        return list(self._front.values())

    def payload(self, key: Hashable) -> Any:
        """The payload of a CURRENT front member (``None`` when the
        member was resurrected by a repair and its payload was not
        retained — re-fetch from the store by key)."""
        return self._payloads.get(key)

    def front(self) -> list[tuple[Hashable, tuple, Any]]:
        """``(key, vector, payload)`` per front member, in order."""
        return [(k, v, self._payloads.get(k))
                for k, v in self._front.items()]

    def diverse(self, k: int | None = None) -> list[Hashable]:
        """Front keys in NSGA-II crowding order (extremes first, clumps
        thinned; ties by front position), optionally truncated to ``k``
        — the exact read-off order of ``pareto.diverse_front``."""
        vecs = self.front_vectors()
        cd = crowding_distance(vecs)
        order = sorted(range(len(vecs)), key=lambda j: (-cd[j], j))
        if k is not None and k > 0:
            order = order[:k]
        keys = self.front_keys()
        return [keys[j] for j in order]

    # -- mutation ---------------------------------------------------------

    def insert(self, key: Hashable, vec: Vector, payload: Any = None,
               ) -> bool:
        """Insert (or last-wins replace) one keyed vector. Returns True
        iff ``key`` sits on the front afterwards."""
        self.inserts += 1
        v = tuple(float(x) for x in vec)
        if self._dim is None:
            self._dim = len(v)
        elif len(v) != self._dim:
            raise ValueError(
                f"objective arity mismatch: got {len(v)}, index holds "
                f"{self._dim}-dim vectors")
        old = self._points.get(key)
        if old is not None:
            if old == v:
                # Same key, same vector: a no-op for the geometry; only
                # refresh the payload when the member is live.
                if key in self._front and payload is not None:
                    self._payloads[key] = payload
                return key in self._front
            # Replacement: the old vector may have been propping the
            # front up (as a member) — rebuild from the surviving points
            # so anything it shadowed is resurrected. Rare (one per
            # store re-run of a cell), O(points * front).
            self._points[key] = v
            self._payloads.pop(key, None)
            if payload is not None:
                self._payloads[key] = payload
            self._rebuild()
            return key in self._front
        self._points[key] = v
        return self._admit(key, v, payload)

    def extend(self, items: Iterable[tuple[Hashable, Vector]]) -> None:
        for key, vec in items:
            self.insert(key, vec)

    # -- internals --------------------------------------------------------

    def _matrix(self) -> np.ndarray:
        if self._mat is None:
            self._mat = (np.array(list(self._front.values()), dtype=float)
                         if self._front else
                         np.zeros((0, self._dim or 0)))
        return self._mat

    def _admit(self, key: Hashable, v: tuple, payload: Any) -> bool:
        """Pure insert-time dominance step for a NEW front candidate."""
        arr = np.asarray(v, dtype=float)
        dominated, kills = dominance_split(self._matrix(), arr)
        if dominated:
            return False
        if kills.any():
            for k in [fk for fk, dead in zip(self._front, kills) if dead]:
                del self._front[k]
                self._payloads.pop(k, None)
        self._front[key] = v
        if payload is not None:
            self._payloads[key] = payload
        self._mat = None
        return True

    def _rebuild(self) -> None:
        """Recompute the front from the current points, preserving
        first-appearance order (one insert-only pass — exactly the
        oracle's semantics). Payloads survive for members that stayed
        on the front; resurrected members keep theirs only if it was
        explicitly re-supplied."""
        self.rebuilds += 1
        kept = self._payloads
        self._front, self._payloads, self._mat = {}, {}, None
        for k, v in self._points.items():
            self._admit(k, v, kept.get(k))
