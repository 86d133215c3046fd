"""Token sampling for the decode engine (greedy / temperature / top-k / top-p).

Counterpart of the JAX package's ``serving/sampling.py``, vectorised over
the slot axis with per-slot parameters.  Selection happens in sorted space,
with the same thresholds:

* ``temperature == 0`` -> greedy (argmax);
* ``top_k > 0`` keeps logits >= the k-th largest;
* ``top_p < 1`` keeps the smallest sorted prefix whose cumulative
  probability reaches p (the best token is always kept).

A ``torch.Generator`` takes the place of the JAX PRNG key: the kept
logits are sampled by Gumbel-max on uniforms drawn from it.  The two
frameworks give different random numbers from the same seed, so only the
keep sets, not the sampled tokens, compare across them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample_tokens", "draw_tokens"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side)."""

    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = disabled
    top_p: float = 1.0         # 1 = disabled

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Sample one token per slot.

    ``logits`` (S, vocab); ``temperature`` (S,) float, 0 = greedy;
    ``top_k`` (S,) int, 0 = off; ``top_p`` (S,) float, 1 = off.  Returns
    (S,) int32 tokens.  ``generator`` must live on ``logits``' device.
    """
    # an all-greedy batch (the common serving case) skips the full-vocab
    # sort/cumsum chain
    if not bool((temperature > 0).any()):
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return draw_tokens(logits, generator, temperature, top_k, top_p)


def draw_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """``sample_tokens`` without its all-greedy shortcut, which reads the
    temperatures on the host: every slot through the sampled path (greedy
    slots take the argmax), device work only, so it can be captured as a
    CUDA graph (the engine's first-token sampler).  It draws what
    ``sample_tokens`` draws where a slot samples."""
    S, vocab = logits.shape
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    temperature = temperature.float()
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]

    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(vocab, device=logits.device)[None, :]

    # top-k: keep logits >= the k-th largest value
    k = torch.clamp(top_k.long(), 0, vocab)
    kth = torch.gather(sorted_logits, 1, torch.clamp(k - 1, min=0)[:, None])
    keep_k = torch.where((k > 0)[:, None], scaled >= kth, torch.ones_like(scaled, dtype=torch.bool))

    # top-p: drop tokens whose preceding cumulative mass already reached p
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = (cum_before < top_p.float()[:, None]) | (ranks == 0)
    min_kept = torch.where(keep_sorted, sorted_logits,
                           torch.full_like(sorted_logits, float("inf"))).amin(dim=-1, keepdim=True)
    keep_p = scaled >= min_kept

    filtered = torch.where(keep_k & keep_p, scaled, torch.full_like(scaled, _NEG))
    sampled = torch.argmax(filtered + _gumbel(filtered.shape, generator, logits.device),
                           dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy_tok)
