"""Random attention cases shared by the port's CPU parity tests and its
card tests (no jax here: the card's machine has none)."""

import numpy as np


def fuzz_case(run):
    """One random case in the spirit of tests/test_fuzz.py: a rule with
    random parameters, a sync mode, 1d or 2d sequences drawn independently
    for q and k, random channel dims and a GQA group."""
    rng = np.random.default_rng(1000 + run)
    kind = ["full", "causal", "local"][run % 3]
    kw = {}
    if kind == "local":
        kw = dict(window_size=int(rng.integers(1, 9)), log2_stride_size=int(rng.integers(0, 3)),
                  is_causal=bool(rng.integers(0, 2)))
    sync = "none_front" if kind == "full" else ["none_front", "scale_front", "scale_end"][
        int(rng.integers(0, 3))]
    if rng.integers(0, 2):
        q_seq, k_seq = (int(rng.integers(33, 400)),), (int(rng.integers(33, 400)),)
    else:
        q_seq = tuple(int(x) for x in rng.integers(3, 20, 2))
        k_seq = tuple(int(x) for x in rng.integers(3, 20, 2))
    d, v_d = (int(x) for x in rng.integers(8, 65, 2))
    return kind, kw, sync, q_seq, k_seq, d, v_d, int(rng.integers(1, 3))
