"""Shared shape-bucketing for jitted program inputs.

Every distinct input shape costs a compile, so dynamic sizes — frame counts, hash-sequence lengths,
episode counts — are rounded up to quarter-steps between powers of two:
a bounded set of compiled programs serves any library, with at most ~14%
padding waste.
"""


def size_bucket(x: int, minimum: int = 256) -> int:
    b = minimum
    while b < x:
        b *= 2
    for q in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, b):
        if x <= q:
            return q
    return b
