"""recurrentgemma-2b: Griffin hybrid — RG-LRU + local attention, pattern
(recurrent, recurrent, local-attn) [arXiv:2402.19427; hf]."""
from repro_torch.core.config import ArchConfig, AttentionKind, HybridConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention=AttentionKind.HYBRID,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "local_attn"),
                        window=2048, d_rnn=2560, conv_width=4),
    act="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma); hf:google/recurrentgemma-2b",
)
