"""Step-interval cadence parser ("start:stop:period,..." syntax).

A copy of ``warpx_tpu.utils.intervals``.

Mirrors the reference's IntervalsParser / SliceParser used for diagnostics,
load-balance and sorting cadences (reference: Source/Utils/Parser/IntervalsParser.H).
A bare number ``n`` means every ``n`` steps; ``a:b`` the inclusive range [a, b]
with period 1; ``a:b:p`` that range with period p (step counts as contained when
(step - a) % p == 0).  Multiple comma-separated slices are OR-ed.
"""

from __future__ import annotations

from typing import List

_INT_MAX = 2**31 - 1

__all__ = ["IntervalsParser"]


class _Slice:
    def __init__(self, spec: str, constants=None):
        from .expression import evaluate_constant

        def _ev(tok: str, default: int) -> int:
            tok = tok.strip()
            if not tok:
                return default
            return int(round(evaluate_constant(tok, constants)))

        parts = spec.split(":")
        if len(parts) == 1:
            self.start, self.stop = 0, _INT_MAX
            self.period = _ev(parts[0], 0)
        elif len(parts) == 2:
            self.start = _ev(parts[0], 0)
            self.stop = _ev(parts[1], _INT_MAX)
            self.period = 1
        else:
            self.start = _ev(parts[0], 0)
            self.stop = _ev(parts[1], _INT_MAX)
            self.period = _ev(parts[2], 1)

    def contains(self, step: int) -> bool:
        if self.period <= 0:
            return False
        return self.start <= step <= self.stop and (step - self.start) % self.period == 0

    def next_contained(self, step: int) -> int:
        if self.period <= 0:
            return _INT_MAX
        nxt = max(step, self.start)
        r = (nxt - self.start) % self.period
        if r:
            nxt += self.period - r
        return nxt if nxt <= self.stop else _INT_MAX


class IntervalsParser:
    def __init__(self, spec: str | List[str] = "", constants=None):
        if isinstance(spec, (list, tuple)):
            spec = ",".join(spec)
        spec = (spec or "").strip()
        self.slices = [
            _Slice(tok, constants) for tok in spec.split(",") if tok.strip()
        ]

    def contains(self, step: int) -> bool:
        return any(s.contains(step) for s in self.slices)

    def is_activated(self) -> bool:
        return any(s.period > 0 for s in self.slices)

    def next_contained(self, step: int) -> int:
        if not self.slices:
            return _INT_MAX
        return min(s.next_contained(step) for s in self.slices)
