"""Shape bucketing shared by the serving plane.

Counterpart of ``hetu_tpu/serving/session.py``; only :func:`next_bucket`
is ported so far (``InferenceSession`` waits for the graph executor).
"""
from __future__ import annotations

__all__ = ["next_bucket"]


def next_bucket(n, buckets=None):
    """Smallest bucket >= n. ``buckets=None`` means the power-of-two
    ladder {1, 2, 4, 8, ...}; an explicit sequence must be sorted."""
    n = int(n)
    if buckets is None:
        b = 1
        while b < n:
            b *= 2
        return b
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(f"batch/seq of {n} exceeds the largest configured "
                     f"bucket {max(buckets)}")
