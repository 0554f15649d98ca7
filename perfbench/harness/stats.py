"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The nearest-rank ``q`` quantile (``inf`` counts as a value; an
    empty sample has none: ``inf``)."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(0, math.ceil(q * len(v)) - 1)]
