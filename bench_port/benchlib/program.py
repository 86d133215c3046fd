"""The system under test: the PyTorch and CUDA port, and nothing else.

The only module of the benchmark that imports ``tf_flash_attention_tpu_torch``.
It maps a configuration file onto the port's ``ModelConfig``, wraps the
seed's weights (``weights.py``) into the port's ``Transformer`` and builds
its serving engine.
"""

from __future__ import annotations

import torch

from . import weights as W


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: a sliding
    window as a causal ``LocalRule`` of ``sliding_window`` keys (a query
    sees ``0 <= q - k < window``), else the causal rule."""
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig
    if float(cfg["rope_theta"]) != 10000.0 or float(cfg["rms_norm_eps"]) != 1e-6:
        raise ValueError("the port fixes rope_theta 10000 and an RMSNorm eps of 1e-6")
    if not cfg.get("tie_word_embeddings"):
        raise ValueError("the port ties the head to the embedding")
    window = cfg.get("sliding_window")
    return ModelConfig(vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
                       n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
                       n_kv_heads=cfg["num_key_value_heads"], d_head=W.head_dim(cfg),
                       d_ff=cfg["intermediate_size"], max_seq=cfg["max_position_embeddings"],
                       dtype=getattr(torch, cfg["torch_dtype"]),
                       rule=LocalRule(window, is_causal=True) if window else CausalRule())


def transformer(mcfg, w: dict, device, master: bool = False):
    """The port's ``Transformer`` holding the weights ``w`` (norm scales
    1): as they are (bf16, frozen), or with ``master`` as float32
    trainable parameters of the same values."""
    from torch import nn
    from tf_flash_attention_tpu_torch.models.transformer import Transformer
    model = Transformer(mcfg, "meta")

    def param(t):
        return nn.Parameter(t.float() if master else t, requires_grad=master)

    ones = lambda: param(torch.ones(mcfg.d_model, device=device, dtype=torch.float32))
    model.embed = param(w["embed"])
    model.final_norm = ones()
    for block, layer in zip(model.layers, w["layers"]):
        block.ln1, block.ln2 = ones(), ones()
        for name in W.PROJ_NAMES:
            setattr(block, name, param(layer[name]))
    return model


def build_engine(cfg: dict, engine: dict, seed: int, device):
    """The port's ``DecodeEngine`` for configuration ``cfg`` with the
    engine settings of a traffic file, on ``device``, its weights drawn
    from ``seed``.  The KV cache is int8 with float32 scales, as the
    reference works it out again.  The engine keeps its own copy of the weights; ours is dropped."""
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    mcfg = model_config(cfg)
    params = transformer(mcfg, W.generate(cfg, seed, device), device)
    settings = EngineConfig(seed=int(seed) % 2**63, quantized_kv=True,
                            kv_quant_dtype=torch.int8, **engine)
    eng = DecodeEngine(mcfg, params, settings, device=device)
    del params
    return eng

