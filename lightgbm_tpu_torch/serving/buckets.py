"""Shape-bucket ladder for the serving tier.

A predict service fed arbitrary row counts would run at a new shape per
distinct n.  The ladder quantizes every request to a small fixed set of
row counts: a request of n rows runs at the smallest bucket >= n
(oversize requests chunk by the largest bucket), so the set of shapes
that can ever reach the card is ``len(buckets)`` per model, all warmable
up front, and a warm bucket's request reuses the caching allocator's
blocks instead of asking the card for new memory.  The padding rows are
sliced off after the device call; the forest kernel walks each row on
its own, so padding cannot change any real row's output
(tests/test_torch_serving.py pins this bit for bit).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..utils import log

#: default ladder when no config is given (mirrors the serving_buckets
#: default in config.py — geometric so pad waste is bounded by ~8x at
#: the bottom and ~2x between rungs)
DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)


class BucketLadder:
    """Sorted, deduplicated ladder of serving batch sizes."""

    def __init__(self, sizes: Sequence[int] = DEFAULT_BUCKETS) -> None:
        sizes = list(sizes or ())
        if not sizes or any(int(b) <= 0 for b in sizes):
            raise log.LightGBMError(
                "serving_buckets must be a non-empty list of positive row "
                f"counts, got {sizes!r}")
        self.sizes: Tuple[int, ...] = tuple(sorted({int(b) for b in sizes}))

    @property
    def max_bucket(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the largest bucket when n exceeds
        the ladder (the caller chunks)."""
        for b in self.sizes:
            if n <= b:
                return b
        return self.max_bucket

    def chunks(self, n: int) -> List[Tuple[int, int, int]]:
        """Cover ``n`` rows with bucket-shaped chunks:
        [(offset, rows, bucket), ...].  Full max-bucket chunks first,
        then one ladder-fitted tail."""
        out: List[Tuple[int, int, int]] = []
        off = 0
        mx = self.max_bucket
        while n - off > mx:
            out.append((off, mx, mx))
            off += mx
        tail = n - off
        if tail > 0:
            out.append((off, tail, self.bucket_for(tail)))
        return out

    def pad_rows(self, n: int) -> int:
        """Total padding rows the ladder adds for an n-row request."""
        return sum(b - rows for _, rows, b in self.chunks(n))

    def __repr__(self) -> str:
        return f"BucketLadder{self.sizes}"
