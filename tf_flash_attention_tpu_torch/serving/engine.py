"""Continuous-batching decode engine for the flagship transformer (PyTorch port).

Counterpart of the JAX package's ``serving/engine.py`` on its single-device
chunked path: prompts run ``prefill_chunk`` tokens at a time (KV write,
then paged prefill attention, then the MLP, per layer), reusing any cached
page-aligned prefix; then every active slot advances one token per
``step()`` (KV append, then paged decode attention).  New requests are
admitted into free slots between steps and finished ones retire and
release their pages.

PyTorch runs eagerly, so there is no compiled step: the engine calls the
model's layers and the four serving kernels directly.  The KV caches are
updated in place by the kernels (the JAX engine donates them instead).
The host keeps a mirror of the page tables, uploaded when it changes, and
of the slots' lengths, so a decode step copies one tensor back to the
host: the next tokens.

Not ported yet (each raises ``NotImplementedError``; see ROADMAP):
tensor/context parallelism (``mesh``), speculative decoding, the bucketed
prefill (its forward kernel now exists; the engine route does not), sliding-window
(``LocalRule``) models with their page eviction, and MoE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..mask_rules import LocalRule
from ..models.transformer import ModelConfig, Transformer, _rms_norm, inference_weights
from .decode import paged_decode_attention
from .kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    append_tokens_batched,
    write_tokens_at,
)
from .prefill import paged_prefill_attention
from .prefix_cache import PrefixCache, SharedPageAllocator
from .sampling import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler

__all__ = ["EngineConfig", "DecodeEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seqs: int = 4
    page_size: int = 128
    n_pages: int = 64           # includes 1 reserved trash page
    max_pages_per_seq: int = 16
    quantized_kv: bool = True
    kv_quant_dtype: object = torch.int8
    seed: int = 0               # seed of the sampling generator
    prefill_mode: str = "chunked"
    prefill_chunk: int = 128
    prefix_caching: bool = True
    speculative_tokens: int = 0


def _rope_cos_sin(pos: torch.Tensor, d: int, theta: float, dtype: torch.dtype):
    """cos/sin tables (n, 1, d/2) for rotary embedding at positions ``pos``."""
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    angles = pos.float()[:, None] * torch.from_numpy(freqs).to(pos.device)[None, :]
    return torch.cos(angles)[:, None, :].to(dtype), torch.sin(angles)[:, None, :].to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (half-split rotation) for single tokens: x (S, h, d),
    pos (S,)."""
    cos, sin = _rope_cos_sin(pos, x.shape[-1], theta, x.dtype)
    return _rotate(x, cos, sin)


class DecodeEngine:
    """Continuous-batching engine on one device (a CUDA card, or the CPU,
    where the kernels' plain PyTorch versions run)."""

    def __init__(self, model_cfg: ModelConfig, params: Transformer,
                 engine_cfg: EngineConfig = EngineConfig(), device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("tensor/context-parallel serving is not ported yet "
                                      "(ROADMAP queue 1: serving, sharded decode)")
        if engine_cfg.speculative_tokens:
            raise NotImplementedError("speculative decoding is not ported yet (ROADMAP "
                                      "queue 2: gamma > 1 paged decode)")
        if engine_cfg.prefill_mode != "chunked":
            raise NotImplementedError("the bucketed prefill is not ported yet (ROADMAP "
                                      "queue 1 item 12, first in the serving queue)")
        rule = model_cfg.rule
        if isinstance(rule, LocalRule):
            raise NotImplementedError("sliding-window serving (page eviction, rolling "
                                      "tables) is not ported yet (ROADMAP queue 1)")
        if type(rule).__name__ != "CausalRule":
            raise ValueError("the serving engine is autoregressive: ModelConfig.rule "
                             "must be CausalRule")
        self.mcfg = model_cfg
        self.ecfg = engine_cfg
        self.device = torch.device(device) if device is not None else params.embed.device
        # projections and embedding cast to the model dtype once, here
        self.model = inference_weights(params, self.device)
        self.ccfg = KVCacheConfig(
            n_kv_heads=model_cfg.n_kv_heads, head_dim=model_cfg.d_head,
            page_size=engine_cfg.page_size, n_pages=engine_cfg.n_pages,
            max_seqs=engine_cfg.max_seqs,
            max_pages_per_seq=engine_cfg.max_pages_per_seq,
            quantized=engine_cfg.quantized_kv, quant_dtype=engine_cfg.kv_quant_dtype,
            dtype=model_cfg.dtype)
        self.trash_page = engine_cfg.n_pages - 1
        self.caches: List[PagedKVCache] = [
            PagedKVCache.create(self.ccfg, self.device) for _ in range(model_cfg.n_layers)]
        # every layer maps the same pages: one device table, mirrored on the host
        for c in self.caches[1:]:
            c.page_tables = self.caches[0].page_tables
        self._tables = np.zeros((engine_cfg.max_seqs, engine_cfg.max_pages_per_seq), np.int32)
        self._tables_dirty = False
        self.allocator = SharedPageAllocator(engine_cfg.n_pages - 1)  # exclude trash
        self.prefix_cache = PrefixCache(engine_cfg.page_size) if engine_cfg.prefix_caching else None
        self.scheduler = Scheduler(engine_cfg.max_seqs, engine_cfg.n_pages - 1,
                                   engine_cfg.page_size)
        self._slots: List[Optional[dict]] = [None] * engine_cfg.max_seqs
        self._next_rid = 0
        self._results: Dict[int, List[int]] = {}
        self._prompts: Dict[int, List[int]] = {}
        self._sampling: Dict[int, tuple] = {}
        self.stats = {"steps": 0, "decode_tokens": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "admitted": 0, "retired": 0,
                      "pages_in_use_peak": 0, "pages_evicted": 0}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(engine_cfg.seed)
        # logits of the last prompt token of the most recently admitted request
        self.last_prefill_logits: Optional[torch.Tensor] = None

    # ---- model functions ----

    def _mlp(self, layer, x):
        h = _rms_norm(x, layer.ln2)
        return x + (F.silu(h @ layer.w1) * (h @ layer.w3)) @ layer.w2

    def _attn_out(self, layer, x, o):
        return x + o.to(x.dtype) @ layer.wo

    def _qkv(self, layer, x, cos, sin):
        cfg = self.mcfg
        n = x.shape[0]
        h = _rms_norm(x, layer.ln1)
        q = (h @ layer.wq).reshape(n, cfg.n_heads, cfg.d_head)
        k = (h @ layer.wk).reshape(n, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer.wv).reshape(n, cfg.n_kv_heads, cfg.d_head)
        return _rotate(q, cos, sin), _rotate(k, cos, sin), v

    def _logits(self, x):
        return _rms_norm(x, self.model.final_norm) @ self.model.embed.T

    @torch.no_grad()
    def _chunk_prefill(self, tokens, slot: int, start: int, true_len: int):
        """One prefill chunk: ``tokens`` (chunk,) at positions
        ``start .. start + chunk`` of ``slot``; returns the logits of the
        last real token."""
        cfg = self.mcfg
        chunk = tokens.shape[0]
        pos = start + torch.arange(chunk, device=self.device)
        cos, sin = _rope_cos_sin(pos, cfg.d_head, cfg.rope_theta, cfg.dtype)
        x = self.model.embed[tokens]
        for layer, cache in zip(self.model.layers, self.caches):
            q, k, v = self._qkv(layer, x, cos, sin)
            write_tokens_at(cache, self.ccfg, slot, start, k.transpose(0, 1),
                            v.transpose(0, 1), true_len, self.trash_page)
            o = paged_prefill_attention(q, cache, self.ccfg, slot, start, true_len,
                                        rule=cfg.rule)
            x = self._attn_out(layer, x, o.reshape(chunk, -1))
            x = self._mlp(layer, x)
        return self._logits(x[true_len - 1])

    @torch.no_grad()
    def _decode_step(self, tokens, active, sps: List[SamplingParams]):
        """One token for every slot: tokens (S,), active (S,) bool."""
        cfg = self.mcfg
        S = tokens.shape[0]
        # positions of the new tokens; computed before layer 0's append
        # advances its lengths in place
        cos, sin = _rope_cos_sin(self.caches[0].lengths, cfg.d_head, cfg.rope_theta, cfg.dtype)
        x = self.model.embed[tokens]
        for layer, cache in zip(self.model.layers, self.caches):
            q, k, v = self._qkv(layer, x, cos, sin)
            append_tokens_batched(cache, self.ccfg, k, v, active, self.trash_page)
            o = paged_decode_attention(q, cache, self.ccfg, rule=cfg.rule)
            x = self._attn_out(layer, x, o.reshape(S, -1))
            x = self._mlp(layer, x)
        logits = self._logits(x)
        if all(sp.temperature == 0 for sp in sps):
            return torch.argmax(logits.float(), dim=-1)
        return self._sample(logits, sps)

    def _sample(self, logits, sps: List[SamplingParams]):
        dev = self.device
        return sample_tokens(
            logits, self._generator,
            torch.tensor([sp.temperature for sp in sps], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_k for sp in sps], dtype=torch.int32, device=dev),
            torch.tensor([sp.top_p for sp in sps], dtype=torch.float32, device=dev))

    # ---- host-side serving loop ----

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               sampling: SamplingParams = SamplingParams(),
               eos_id: Optional[int] = None) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        rid = self._next_rid
        self._next_rid += 1
        self.scheduler.enqueue(Request(rid, len(prompt), max_new_tokens))
        self._results[rid] = list(prompt)
        self._prompts[rid] = list(prompt)
        self._sampling[rid] = (sampling, eos_id)
        return rid

    def _set_table(self, slot: int, logical: int, page: int) -> None:
        self._tables[slot, logical] = page
        self._tables_dirty = True

    def _sync_tables(self) -> None:
        """Upload the host page tables if they changed (one small copy)."""
        if self._tables_dirty:
            self.caches[0].page_tables.copy_(torch.from_numpy(self._tables))
            self._tables_dirty = False

    def _alloc_pages(self, slot: int, n: int):
        """Allocate fresh pages, evicting LRU prefix-cache entries if dry."""
        if n > self.allocator.free_pages and self.prefix_cache is not None:
            self.prefix_cache.evict(self.allocator, n)
        return self.allocator.alloc(slot, n)

    def _prefill_chunked(self, prompt: List[int], slot: int):
        """Chunked prefill against the paged cache, reusing any cached
        page-aligned prefix (shared refcounted pages).  Returns the logits
        of the last prompt token."""
        ps = self.ecfg.page_size
        n_prompt_pages = -(-len(prompt) // ps)
        if n_prompt_pages > self.ecfg.max_pages_per_seq:
            raise RuntimeError(f"prompt needs {n_prompt_pages} pages but "
                               f"max_pages_per_seq={self.ecfg.max_pages_per_seq}")
        cached_tokens, cached_pages = 0, []
        if self.prefix_cache is not None:
            # always leave >= 1 token to prefill so there are logits to sample
            cached_tokens, cached_pages = self.prefix_cache.lookup(
                prompt, max_tokens=len(prompt) - 1)
        if cached_pages:
            self.allocator.share(slot, cached_pages)
        pages = list(cached_pages) + self._alloc_pages(slot, n_prompt_pages - len(cached_pages))
        for logical, page in enumerate(pages):
            self._set_table(slot, logical, page)
        self._sync_tables()
        chunk = self.ecfg.prefill_chunk
        start, last_logits = cached_tokens, None
        while start < len(prompt):
            n = min(chunk, len(prompt) - start)
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            toks = prompt[start:start + n] + [0] * (chunk - n)
            last_logits = self._chunk_prefill(
                torch.tensor(toks, dtype=torch.long, device=self.device), slot, start, n)
            start += n
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, pages, self.allocator)
        return last_logits

    def _admit(self):
        for req, slot in self.scheduler.admit():
            self.stats["admitted"] += 1
            prompt = self._prompts.pop(req.rid)
            last_logits = self._prefill_chunked(prompt, slot)
            self.last_prefill_logits = last_logits
            sp, eos_id = self._sampling.pop(req.rid, (SamplingParams(), None))
            if sp.temperature > 0:
                first_tok = int(self._sample(last_logits[None], [sp])[0])
            else:
                first_tok = int(torch.argmax(last_logits.float()))
            self._results[req.rid].append(first_tok)
            self._slots[slot] = {
                "rid": req.rid,
                "remaining": req.max_new_tokens - 1,
                "last": first_tok,
                "length": len(prompt),
                "sampling": sp,
                "eos_id": eos_id,
                # the budget reserved at admission, handed back at retirement
                "reserved": req.pages_needed(self.ecfg.page_size),
            }
            if eos_id is not None and first_tok == eos_id:
                self._slots[slot]["remaining"] = 0

    def _ensure_capacity(self):
        """Map a page for every active slot's next append."""
        ps, mp = self.ecfg.page_size, self.ecfg.max_pages_per_seq
        for slot, st in enumerate(self._slots):
            if st is None or st["length"] % ps:
                continue
            logical = st["length"] // ps
            if logical >= mp:
                raise RuntimeError(f"sequence needs logical page {logical} but "
                                   f"max_pages_per_seq={mp}")
            self._set_table(slot, logical, self._alloc_pages(slot, 1)[0])

    def _retire(self):
        for slot, st in enumerate(self._slots):
            if st is not None and st["remaining"] <= 0:
                self.stats["retired"] += 1
                self.allocator.free(slot)
                self.scheduler.release(slot, st["reserved"])
                # zero the slot length so the dead slot reads no pages
                for cache in self.caches:
                    cache.lengths[slot] = 0
                self._slots[slot] = None

    @property
    def num_active(self) -> int:
        return sum(st is not None for st in self._slots)

    def step(self) -> int:
        """Admit, decode one token for all active slots, retire.  Returns
        the number of tokens produced this step."""
        self._admit()
        # requests finished at prefill (EOS first, or max_new_tokens == 1)
        # retire before consuming a decode step
        self._retire()
        if self.num_active == 0:
            return 0
        self._ensure_capacity()
        self._sync_tables()
        self.stats["steps"] += 1
        self.stats["pages_in_use_peak"] = max(
            self.stats["pages_in_use_peak"],
            (self.ecfg.n_pages - 1) - self.allocator.free_pages)
        tokens = torch.tensor([st["last"] if st else 0 for st in self._slots],
                              dtype=torch.long, device=self.device)
        active = torch.tensor([st is not None for st in self._slots], device=self.device)
        sps = [st["sampling"] if st else SamplingParams() for st in self._slots]
        next_host = self._decode_step(tokens, active, sps).cpu().numpy()
        produced = 0
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tok = int(next_host[slot])
            self._results[st["rid"]].append(tok)
            st["last"] = tok
            st["length"] += 1
            st["remaining"] -= 1
            if st["eos_id"] is not None and tok == st["eos_id"]:
                st["remaining"] = 0
            produced += 1
        self.stats["decode_tokens"] += produced
        self._retire()
        return produced

    def run(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: token list (prompt + generated)}."""
        steps = 0
        while (self.scheduler.queued or self.num_active) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self._results)
