"""Readings of the program's own spans in a traced window: the host ranges
`vitad::<name>` that the port opens at its layer boundaries while a profiler
runs (`vit_ad_tpu_torch/utils/profiling.span`), as `Trace` keeps them among
its host ops and ranges. Each reading is ms a unit (batch or step), or None
for another kind of cell, or where no such span lies in the window."""

from __future__ import annotations

from typing import List, Optional, Tuple

from harness.trace import _union

PREFIX = "vitad::"


def intervals(trace, name: Optional[str] = None) -> List[Tuple[int, int]]:
    """The union of the spans `vitad::<name>` (with None, of every span of
    the program) clipped to the window, sorted: a span nested in another
    counts once."""
    hit = (lambda n: n.startswith(PREFIX)) if name is None else (lambda n: n == PREFIX + name)
    return _union([(a, b) for a, b, n in trace._host if hit(n)], trace.lo, trace.hi)


def idle(trace) -> List[Tuple[int, int]]:
    """The window's stretches in which no kernel and no copy ran."""
    out, prev = [], trace.lo
    for a, b in trace.busy:
        if a > prev:
            out.append((prev, a))
        prev = b
    if trace.hi > prev:
        out.append((prev, trace.hi))
    return out


def overlap_ns(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(r, kind: str, name: str) -> Optional[float]:
    """Host ms a unit inside the spans `vitad::<name>`."""
    if r.kind != kind or r.units == 0:
        return None
    spans = intervals(r.trace, name)
    if not spans:
        return None
    return 1e-6 * sum(b - a for a, b in spans) / r.units


def idle_ms(r, kind: str, name: Optional[str] = None) -> Optional[float]:
    """Device-idle ms a unit that lies inside the spans `vitad::<name>`
    (with None, inside any span of the program); None where the window
    holds no device activity at all."""
    if r.kind != kind or r.units == 0 or not r.trace.busy:
        return None
    spans = intervals(r.trace, name)
    if not spans:
        return None
    return 1e-6 * overlap_ns(spans, idle(r.trace)) / r.units
