"""rwkv6-7b (Finch): attention-free, data-dependent decay
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]."""
from repro_torch.core.config import ArchConfig, AttentionKind, RWKVConfig

ARCH = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d_model / head_size
    n_kv_heads=0,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionKind.NONE,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892 (Eagle & Finch); hf:RWKV/rwkv-6-world-7b",
)
