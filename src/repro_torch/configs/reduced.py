"""Reduced same-family configs for CPU smoke tests.

Every assigned architecture gets a shrunken twin: same family, same block
structure (GQA ratios, MoE routing, hybrid pattern, MLA ranks scaled), tiny
widths — one forward step runs on the CPU in seconds. The full configs
run on the card (``chip_smoke.py`` serves recurrentgemma-2b at full width).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import (ArchConfig, AttentionKind,
                                     HybridConfig, MLAConfig, MoEConfig,
                                     RWKVConfig)
from repro_torch.configs import ARCHS


def reduced(arch: ArchConfig) -> ArchConfig:
    kw = dict(
        n_layers=min(arch.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads else 0,
        head_dim=16,
        d_ff=96,
        vocab_size=128,
        n_patches=8,
    )
    if arch.attention == AttentionKind.MLA:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
        kw["n_kv_heads"] = 4
    if arch.moe is not None:
        # capacity_factor 4.0: reduced configs route ~dozens of tokens, where
        # the production 1.25 factor would drop tokens and break exact
        # decode/forward parity
        kw["moe"] = dataclasses.replace(
            arch.moe, n_experts=4, top_k=2, d_expert=32,
            dense_d_ff=48 if arch.moe.dense_d_ff else None,
            capacity_factor=4.0)
    if arch.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(arch.hybrid, window=8, d_rnn=64)
        kw["n_layers"] = 4  # (rglru, rglru, local_attn) + tail rglru
        kw["n_kv_heads"] = 1
    if arch.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, mix_lora=8)
        kw["n_heads"] = 4
        kw["head_dim"] = 16
    return dataclasses.replace(arch, **kw)


REDUCED = {name: reduced(a) for name, a in ARCHS.items()}
