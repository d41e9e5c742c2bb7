"""qwen3-1.7b: dense GQA with qk-norm, tied embeddings [hf:Qwen/Qwen3-1.7B]."""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-1.7B (assignment cites Qwen/Qwen3-8B family)",
)
