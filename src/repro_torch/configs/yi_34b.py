"""yi-34b: llama-architecture dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652 (Yi: Open Foundation Models); hf:01-ai/Yi-34B",
)
