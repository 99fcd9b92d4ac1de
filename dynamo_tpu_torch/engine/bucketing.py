"""Shape bucketing: the one module that mints dispatch-shape sizes.

The reference bounds every dispatch shape because XLA compiles one program
per shape. Eager PyTorch compiles nothing, but the bucketing stays: it
decides which prefill chunks batch together (scheduler `_lane_cap`), it
keeps the scheduler's cost model keyed on a small shape set, and static
shapes are what a later CUDA-graph capture of the decode block needs.
"""

from __future__ import annotations

from typing import Sequence


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that holds n (the largest if none do)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
