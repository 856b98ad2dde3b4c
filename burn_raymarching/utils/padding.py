"""Primitive-count padding buckets.

XLA traces static shapes, but density control changes M every stage. Padding
M to the next bucket bounds recompiles to O(log M) over a whole run while
masked soft-min/softmax keep semantics exact.
"""

from __future__ import annotations


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket ≥ n (≥ ``minimum``).

    Power-of-two buckets mean at most one recompile per doubling.
    """
    if n <= minimum:
        return minimum
    b = minimum
    while b < n:
        b *= 2
    return b
