"""The numbers that decide `correct`: each a gap between what the timed path
produced and what the plain reference works out from the same inputs, held
against the cell's limit (`limits/<cell>.json`)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

import numpy as np


def abs_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest absolute gap."""
    return float(np.max(np.abs(np.asarray(prog, np.float64) - np.asarray(ref, np.float64))))


def range_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap over the reference's range (max - min)."""
    ref = np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min())
    return abs_gap(prog, ref) / span if span > 0 else math.inf


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The worst step's |loss - reference| over |reference|."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Iterable[str] = ()) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| over its own reference norm,
    leaving out the leaves in `skip`."""
    skip = set(skip)
    return {k: abs(prog[k] - ref[k]) / ref[k] for k in ref if k not in skip}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Iterable[str] = ()) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, skip).values())


def rounding_leaves(raw_grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is under `share` of the median
    leaf's: moved by round-off alone under Adam, so left out of the change."""
    med = statistics.median(raw_grad.values())
    return sorted(k for k, v in raw_grad.items() if v < share * med)


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): every number that the cell's
    limits name is finite and at or under its limit; the others are not
    compared."""
    checks, ok = {}, True
    for name, lim in limits.items():
        if name not in values:
            raise KeyError(f"the cell's limits name {name!r}, which the check does not read")
        value = values[name]
        good = math.isfinite(value) and value <= lim
        ok = ok and good
        checks[name] = {"value": value, "limit": lim}
    return ok, checks
