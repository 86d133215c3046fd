"""Operations and bytes the inputs need, from shapes and lengths alone.

Every roofline and MFU share of the benchmark divides one of these counts
by a peak of ``peaks.py`` and by a measured time.  A count is the least
work the inputs need, whatever a kernel does beyond it: attention counts
the (query, key) pairs its mask leaves visible, a byte is read once, a
product of an (m, k) and a (k, n) matrix is ``2 m k n`` operations.  The
configuration is the dict of a ``configs/*.json`` file.
"""

from __future__ import annotations

from typing import Iterable, Optional

from .weights import head_dim, layer_shapes


def window_of(cfg: dict) -> Optional[int]:
    """Keys a query sees at most (None: every earlier key)."""
    return cfg.get("sliding_window") or None


def visible_pairs(start: int, n: int, window: Optional[int]) -> int:
    """Visible (query, key) pairs of the queries at positions ``start ..
    start + n - 1`` under a causal mask, or a causal window of ``window``
    keys (the query's own among them)."""
    if n <= 0:
        return 0
    lo, hi = start, start + n - 1

    def causal(a: int, b: int) -> int:          # sum of (p + 1) for p in a..b
        return (b - a + 1) * (a + b + 2) // 2

    if not window:
        return causal(lo, hi)
    cut = min(hi, window - 1)                   # queries below the cut see p + 1 keys
    pairs = causal(lo, cut) if lo <= cut else 0
    full = hi - max(lo, window) + 1             # the rest see ``window`` keys each
    return pairs + max(full, 0) * window


def keys_needed(start: int, n: int, window: Optional[int]) -> int:
    """Distinct keys the queries ``start .. start + n - 1`` read together."""
    lo = max(0, start - window + 1) if window else 0
    return start + n - lo


def attn_flops(cfg: dict, pairs: int) -> int:
    """QK^T and PV of ``pairs`` visible pairs over every query head."""
    return 4 * head_dim(cfg) * cfg["num_attention_heads"] * pairs


def layer_matmul_params(cfg: dict) -> int:
    return sum(a * b for a, b in layer_shapes(cfg).values())


def token_flops(cfg: dict, with_head: bool) -> int:
    """One token's projections and MLP over every layer, and the head's
    product when its logits are needed; attention is counted apart."""
    f = 2 * layer_matmul_params(cfg) * cfg["num_hidden_layers"]
    return f + (2 * cfg["vocab_size"] * cfg["hidden_size"] if with_head else 0)


def prefill_flops(cfg: dict, start: int, n: int) -> int:
    """A prompt's tokens ``start .. start + n - 1`` through the model, and
    the head once, for the last token's logits."""
    pairs = visible_pairs(start, n, window_of(cfg)) * cfg["num_hidden_layers"]
    return n * token_flops(cfg, False) + attn_flops(cfg, pairs) + \
        2 * cfg["vocab_size"] * cfg["hidden_size"]


def decode_flops(cfg: dict, keys: Iterable[int]) -> int:
    """One decode step: a token a slot, slot ``i`` attending over
    ``keys[i]`` positions (its own among them)."""
    w = window_of(cfg)
    keys = list(keys)
    pairs = sum(min(k, w) if w else k for k in keys) * cfg["num_hidden_layers"]
    return len(keys) * token_flops(cfg, True) + attn_flops(cfg, pairs)


# ---- the serving kernels' work, one launch a layer ----

def kv_token_bytes(cfg: dict, payload: int = 1, scale: int = 4) -> int:
    """One cached token of one layer: K and V payloads and their scales
    over the KV heads."""
    return cfg["num_key_value_heads"] * 2 * (head_dim(cfg) * payload + scale)


def decode_attn_work(cfg: dict, keys: Iterable[int], act: int = 2):
    """(operations, bytes) of one ``paged_decode`` launch: each slot's q
    (every query head) against the keys it sees, its output written."""
    w = window_of(cfg)
    qo = 2 * cfg["num_attention_heads"] * head_dim(cfg) * act
    flops = byts = 0
    for k in keys:
        seen = min(k, w) if w else k
        flops += attn_flops(cfg, seen)
        byts += seen * kv_token_bytes(cfg) + qo
    return flops, byts


def prefill_attn_work(cfg: dict, start: int, n: int, act: int = 2):
    """(operations, bytes) of one ``paged_prefill`` launch: a chunk of
    ``n`` queries at ``start``, the keys they see read once."""
    w = window_of(cfg)
    flops = attn_flops(cfg, visible_pairs(start, n, w))
    qo = 2 * n * cfg["num_attention_heads"] * head_dim(cfg) * act
    return flops, qo + keys_needed(start, n, w) * kv_token_bytes(cfg)


def chunks(start: int, length: int, chunk: int):
    """The (start, n) of each prefill chunk of a prompt of ``length``
    tokens whose first ``start`` are cached."""
    out = []
    while start < length:
        n = min(chunk, length - start)
        out.append((start, n))
        start += n
    return out


def bound_seconds(flops: float, byts: float, peaks) -> float:
    """The least time: the larger of operations over the bf16 peak and
    bytes over the memory bandwidth."""
    return max(flops / peaks.bf16_flops, byts / peaks.hbm_bytes)
