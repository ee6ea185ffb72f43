"""Whole-window statistics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile of all `values`, by linear interpolation
    between the closest ranks (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ctx_sum(prompt_len: int, first: int, last: int) -> int:
    """Sum of attention contexts of a request's generated tokens
    first..last-1: token j is decoded with the prompt's first S-1 tokens
    and j earlier outputs in the cache, plus itself: S + j."""
    n = last - first
    return n * prompt_len + (first + last - 1) * n // 2
