"""phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE with GQA
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.core.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="phi3.5-moe",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=6400),
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
