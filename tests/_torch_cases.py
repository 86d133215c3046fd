"""Random attention cases shared by the port's CPU parity tests and its
card tests (no jax here: the card's machine has none)."""

import numpy as np

#: the fuzz runs also drawn in float64 (the chunked path), as test_fuzz.py's
#: float64 parametrization does, with few runs
FLOAT64_RUNS = range(2)


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


class CheckerCausal:
    """A custom mask rule, mixed into either package's ``MaskRule``: causal,
    and visible only where ``(q_flat // 32 + k_flat // 32) % 2 == 0`` (a
    checkerboard of 32-position squares), with conservative tile tests
    (every tile live, none fully visible).  Written with operators only, so
    one ``check`` runs on numpy, torch and jnp."""

    is_full = False

    def check(self, pack, q_coords, k_coords, q_flat, k_flat):
        return (q_flat >= k_flat) & ((q_flat // 32 + k_flat // 32) % 2 == 0)

    def tile_live(self, pack, q_coord_lo, q_coord_hi, k_coord_lo, k_coord_hi,
                  q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        return k_flat_lo == k_flat_lo  # all-True

    def tile_fully_visible(self, pack, q_coord_lo, q_coord_hi, k_coord_lo, k_coord_hi,
                           q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        return k_flat_lo != k_flat_lo  # all-False
