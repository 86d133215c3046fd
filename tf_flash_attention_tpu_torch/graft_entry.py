"""Driver entry points of the port (counterpart of the root
``__graft_entry__.py``, which drives the JAX package).

``entry()`` returns a forward step of the flagship transformer LM and its
arguments, on one device.  ``dryrun_multichip(n)`` runs, on meshes of
``n`` devices, one step of each parallel training path and the tp x cp
serving engine at tiny shapes, in the JAX entry's order and with its
printed lines:

  (a) dp x tp x sp x ep: the sharded step, batch on ``data``, heads and
      MLP over ``model`` with sequence-parallel norms, the MoE experts over
      ``model``;
  (b) pp x dp: the GPipe step over a ``pipe`` axis;
  (c) dp x tp x cp: ring attention over a ``context`` axis inside the
      training step;
  (e) Ulysses and a local-rule ring on a (data, model, context) mesh,
      outputs and gradients against the unsharded ``attend``;
  (d) tp x cp serving: the decode engine on a (model, seq) mesh, its
      greedy tokens equal to the dense forward's in full with a float32
      cache; with an int8 cache, equal to the dense forward's up to the
      first top-2 tie and to the single-device engine's in full.

The meshes are single-controller (``parallel/mesh.py``): one process
drives every shard, and the devices may repeat, so ``n`` shards of one
card run every path.  ``devices`` defaults to the first ``n`` cards, or to
``n`` shards of ``cuda:0`` where fewer cards exist.

    python -m tf_flash_attention_tpu_torch.graft_entry
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .models.transformer import ModelConfig, forward, init_params

__all__ = ["ENTRY_CONFIG", "entry", "dryrun_multichip"]

#: the entry's model (the root ``__graft_entry__.py``'s)
ENTRY_CONFIG = ModelConfig(vocab=1024, d_model=256, n_layers=2, n_heads=4, n_kv_heads=4,
                           d_head=64, d_ff=768, max_seq=256)


# a top-2 logit gap under this is a tie, where int8 KV rounding may pick
# either token
GAP_TIE = 1e-3


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def entry(device=None):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward of
    the model ``params`` holds (``params.cfg``), float32 logits (2, 256,
    1024) here; weights random from seed 0 and tokens (2, 256) zeros on
    ``device`` (the card when None)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    params = init_params(ENTRY_CONFIG, _generator(0, device), device)
    tokens = torch.zeros((2, 256), dtype=torch.long, device=device)

    def fn(params, tokens):
        return forward(params.cfg, params, tokens)

    return fn, (params, tokens)


def _devices(n_devices: int, devices):
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) < n_devices:
            raise ValueError(f"{len(devices)} devices for a mesh of {n_devices}")
        return devices[:n_devices]
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass devices (e.g. ['cpu'] * n) to run elsewhere")
    if cards >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device("cuda", 0)] * n_devices


def _adamw(params, device):
    # optax.adamw(1e-3)'s defaults; capturable on CUDA, where a step on one
    # card is captured as a CUDA graph
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                             capturable=device.type == "cuda")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run (a)-(e) of the module docstring on meshes of ``n_devices``
    shards of ``devices``; each prints its line, and a check that fails
    raises."""
    from .block_sizes import BlockConfig
    from .mask_rules import CausalRule, LocalRule
    from .models.pipeline import make_pipeline_train_step, stack_stage_params
    from .models.transformer import make_sharded_train_step
    from .parallel import make_mesh, ring_flash_attention, ulysses_flash_attention

    devices = _devices(n_devices, devices)
    home = devices[0]
    # dp x tp mesh: prefer a mixed mesh (dp >= 2) with tp dividing heads
    tp = 1
    for cand in (4, 2, 8):
        if n_devices % cand == 0 and 8 % cand == 0 and (n_devices // cand) >= 1:
            tp = cand
            if n_devices // cand >= 2:
                break
    dp = n_devices // tp
    mesh = make_mesh((dp, tp), ("data", "model"), devices)

    # (a) dp/tp/sp + ep (MoE experts sharded over the model axis)
    cfg = ModelConfig(vocab=512, d_model=128, n_layers=2, n_heads=8, n_kv_heads=8,
                      d_head=32, d_ff=256, max_seq=128, n_experts=max(tp, 2))
    params = init_params(cfg, _generator(0, home), home)
    step = make_sharded_train_step(cfg, mesh, _adamw(params.parameters(), home))
    loss = step(params, torch.zeros((2 * dp, 129), dtype=torch.long, device=home))
    print(f"dryrun_multichip({n_devices}) dp/tp/sp/ep: "
          f"mesh={dict(mesh.shape)} experts={cfg.n_experts} loss={float(loss):.4f}", flush=True)

    # (b) pp x dp pipeline step
    pp = 2 if n_devices % 2 == 0 else 1
    if pp > 1:
        dp2 = n_devices // pp
        mesh_pp = make_mesh((dp2, pp), ("data", "pipe"), devices)
        cfg_pp = ModelConfig(vocab=512, d_model=128, n_layers=2 * pp, n_heads=4, n_kv_heads=4,
                             d_head=32, d_ff=256, max_seq=128)
        staged = stack_stage_params(cfg_pp, init_params(cfg_pp, _generator(1, home), home), pp)
        step_pp, _ = make_pipeline_train_step(cfg_pp, mesh_pp, _adamw(staged.parameters(), home),
                                              n_microbatches=2)
        loss2 = step_pp(staged, torch.zeros((2 * dp2, 129), dtype=torch.long, device=home))
        print(f"dryrun_multichip({n_devices}) pp/dp: "
              f"mesh={dict(mesh_pp.shape)} loss={float(loss2):.4f}", flush=True)

    # (c) dp x tp x cp: ring attention inside the full training step
    if n_devices % 8 == 0:
        mesh_cp = make_mesh((n_devices // 4, 2, 2), ("data", "model", "context"), devices)
        cfg_cp = ModelConfig(vocab=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                             d_head=32, d_ff=256, max_seq=256, context_parallel=True)
        params_cp = init_params(cfg_cp, _generator(2, home), home)
        step_cp = make_sharded_train_step(cfg_cp, mesh_cp, _adamw(params_cp.parameters(), home))
        loss3 = step_cp(params_cp, torch.zeros((2 * (n_devices // 4), 257), dtype=torch.long,
                                               device=home))
        print(f"dryrun_multichip({n_devices}) dp/tp/cp: "
              f"mesh={dict(mesh_cp.shape)} loss={float(loss3):.4f}", flush=True)

    # (e) dp x tp x cp Ulysses (all-to-all head <-> sequence resharding) and
    # a local-rule ring, forward and gradients, against the single-device
    # op, so every parallel module is checked here, not only by the tests
    if n_devices % 8 == 0:
        from .ops.attend import AttendParams, attend
        from .sync_modes import make_sync_pack

        dp_u = n_devices // 4
        mesh_u = make_mesh((dp_u, 2, 2), ("data", "model", "context"), devices)
        blocks = BlockConfig(128, 128, 128, 128, 128, 128)
        rng = np.random.default_rng(5)
        B_u = dp_u   # one batch row per data shard

        def mk():
            return torch.from_numpy(rng.uniform(-1, 1, (B_u, 8, 256, 32)).astype(np.float32)
                                    ).to(home)

        q_u, k_u, v_u, do_u = mk(), mk(), mk(), mk()
        pack_u = make_sync_pack("none_front", (256,), (256,))

        def run(fn):
            """(output, gradients) of ``fn(q, k, v)`` under the cotangent
            ``do_u``."""
            leaves = [x.clone().requires_grad_(True) for x in (q_u, k_u, v_u)]
            out = fn(*leaves)
            out.backward(do_u)
            return out.detach(), [x.grad for x in leaves]

        def dense(rule):
            params_a = AttendParams(pack=pack_u, rule=rule, config=blocks, scale=1.0 / np.sqrt(32))

            def fn(q, k, v):
                o = attend(*(x.reshape(B_u * 8, 256, 32) for x in (q, k, v)), params_a)[0]
                return o.reshape(B_u, 8, 256, 32)
            return fn

        o_u, g_u = run(ulysses_flash_attention(mesh_u, CausalRule(), block_config=blocks))
        o_ref, g_ref = run(dense(CausalRule()))
        # the JAX entry's assert_allclose(rtol=2e-4, atol=2e-4)
        close = functools.partial(torch.testing.assert_close, rtol=2e-4, atol=2e-4)
        close(o_u, o_ref, msg="ulysses forward")
        for name, got, want in zip(("dQ", "dK", "dV"), g_u, g_ref):
            close(got, want, msg=f"ulysses {name}")
        rule_l = LocalRule(window_size=48, log2_stride_size=0, is_causal=True)
        o_r, g_r = run(ring_flash_attention(mesh_u, rule=rule_l, block_config=blocks))
        o_lref, g_lref = run(dense(rule_l))
        close(o_r, o_lref, msg="local-rule ring forward")
        for name, got, want in zip(("dQ", "dK", "dV"), g_r, g_lref):
            close(got, want, msg=f"local-rule ring {name}")
        print(f"dryrun_multichip({n_devices}) dp/tp/cp ulysses+ring: "
              f"mesh={dict(mesh_u.shape)} ulysses fwd+grads parity ok "
              f"(|dQ|={float(g_u[0].abs().mean()):.4f}), "
              f"local-rule ring parity ok (fwd+grads)", flush=True)

    # (d) tp x cp serving: the decode engine on a (model x seq) mesh (heads
    # tensor-parallel, KV-cache pages sequence-parallel) must reproduce the
    # dense model's greedy tokens: in full on a float32 cache; on an int8
    # cache up to the first top-2 tie, where int8 KV rounding may pick the
    # other token (the JAX entry's weights have margins; drawn on the CPU,
    # these random weights have a gap of 6.3e-4 at the 9th new token), and
    # the single-device engine's on the same int8 cache exactly
    if n_devices % 4 == 0:
        from .serving.engine import DecodeEngine, EngineConfig

        cfg_s = ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_head=16, d_ff=128, max_seq=256, dtype=torch.float32)
        params_s = init_params(cfg_s, _generator(0, home), home)
        mesh_s = make_mesh((2, n_devices // 2), ("model", "seq"), devices)
        ecfg = EngineConfig(max_seqs=2, page_size=16, n_pages=8, max_pages_per_seq=4,
                            quantized_kv=True, prefill_mode="chunked", prefill_chunk=16,
                            prefix_caching=False)
        prompt = [(i * 7 + 1) % cfg_s.vocab for i in range(40)]

        def serve(ecfg, **where):
            eng = DecodeEngine(cfg_s, params_s, ecfg, **where)
            rid = eng.submit(prompt, max_new_tokens=10)
            return eng, eng.run(max_steps=50)[rid]

        _, exact = serve(dataclasses.replace(ecfg, quantized_kv=False), mesh=mesh_s)
        eng, got = serve(ecfg, mesh=mesh_s)
        _, flat = serve(ecfg, device=home)
        want, tie, n_equal = list(prompt), None, None
        with torch.no_grad():
            for i in range(10):
                logits = forward(cfg_s, params_s, torch.tensor([want], device=home))[0, -1]
                gap = float(logits.topk(2).values.diff().abs())
                if tie is None and gap < GAP_TIE:
                    tie, n_equal = f"at new token {i}, gap {gap:.3g}", len(want)
                want.append(int(logits.argmax()))
        n_equal = n_equal or len(want)
        if exact != want:
            raise AssertionError(f"tp x cp engine's greedy tokens on a float32 cache {exact}: "
                                 f"the dense forward's {want}")
        if got != flat or got[:n_equal] != want[:n_equal]:
            raise AssertionError(f"tp x cp engine's greedy tokens {got}: the single-device "
                                 f"engine's {flat}, the dense forward's {want} (first top-2 "
                                 f"tie: {tie})")
        print(f"dryrun_multichip({n_devices}) tp x cp serving: "
              f"mesh={dict(mesh_s.shape)} greedy parity ok "
              f"(tp={eng.tp} cp={eng.cp}, {len(got) - len(prompt)} tokens; float32 cache: equal "
              f"to the dense forward's in full; int8 cache: equal to the dense forward's up to "
              f"the first top-2 tie ({tie or 'none'}), to the single-device engine's in full)", flush=True)


def main() -> None:
    """The entry forward and ``dryrun_multichip`` on the card, over every
    card or, where fewer than 8 exist, 8 shards of ``cuda:0``."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the graft entry runs on the card")
    fn, fn_args = entry()
    with torch.no_grad():
        out = fn(*fn_args)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(max(torch.cuda.device_count(), 8))


if __name__ == "__main__":
    main()
