"""Fixed-shape request bucketing, counterpart of ``repro.serve.bucketing``.

Every request is padded up to a bucket from a small geometric ladder and,
when larger than the biggest bucket, split into max-bucket chunks plus one
bucketed tail.  The reference buckets to bound its jit cache; the port has
no compile cache, and keeps the ladder because the front end's per-bucket
latency classes and the one-kernel-launch-per-chunk contract of
``TuckerServer.predict`` are stated in its terms.

Padding rows point at index 0 of every mode; the engine slices the padded
predictions back to the true batch, so pad entries never escape.
"""
from __future__ import annotations


DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_BUCKET = 2048
DEFAULT_GROWTH = 2


def bucket_ladder(
    max_bucket: int = DEFAULT_MAX_BUCKET,
    min_bucket: int = DEFAULT_MIN_BUCKET,
    growth: int = DEFAULT_GROWTH,
) -> tuple[int, ...]:
    """Geometric bucket sizes (min, min·g, …, ≥max)."""
    if not (min_bucket >= 1 and max_bucket >= min_bucket and growth >= 2):
        raise ValueError(
            f"bad ladder spec: min={min_bucket} max={max_bucket} g={growth}")
    out = [min_bucket]
    while out[-1] < max_bucket:
        out.append(out[-1] * growth)
    return tuple(out)


def bucket_for(n: int, ladder: tuple[int, ...]) -> int:
    """Smallest bucket ≥ n (n must not exceed the ladder top)."""
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds largest bucket {ladder[-1]}; "
                     "chunk with split_batch first")


def split_batch(n: int, ladder: tuple[int, ...]) -> list[tuple[int, int]]:
    """Cover a batch of n with bucketed chunks: [(start, bucket), ...].

    Full max-bucket chunks followed by one bucketed tail.
    """
    if n <= 0:
        raise ValueError(f"empty batch (n={n})")
    top = ladder[-1]
    out = []
    start = 0
    while n - start > top:
        out.append((start, top))
        start += top
    out.append((start, bucket_for(n - start, ladder)))
    return out
