"""deepseek-v3-671b: MLA + 256-expert top-8 MoE (1 shared expert), 3 leading
dense layers, multi-token prediction head [arXiv:2412.19437]."""
from repro_torch.core.config import ArchConfig, AttentionKind, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v3",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: per-head view; true cache is the 512-d latent
    head_dim=128,
    d_ff=2048,               # routed-expert FFN width (assignment table)
    vocab_size=129280,
    attention=AttentionKind.MLA,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048,
                  n_shared_experts=1, n_dense_layers=3, dense_d_ff=18432),
    mtp=True,
    rope_theta=10_000.0,
    source="arXiv:2412.19437 (DeepSeek-V3); hf:deepseek-ai/DeepSeek-V3",
)
