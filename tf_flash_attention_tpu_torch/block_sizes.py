"""Layout constants shared with the JAX package.

Only what the serving slice needs: the KV cache keeps the JAX layout
``head_dim_store = pad_to(head_dim, LANE)`` so cache states compare
element for element with the reference (at head_dim 128 the padding is
empty).
"""

LANE = 128


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m
