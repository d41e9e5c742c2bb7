"""qwen2-vl-2b: VLM backbone with M-RoPE; vision frontend is a stub
(input_specs supplies precomputed patch embeddings + 3D positions)
[arXiv:2409.12191; hf]."""
from repro_torch.core.config import ArchConfig, RopeKind

ARCH = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope=RopeKind.MROPE,
    rope_theta=1_000_000.0,
    vlm=True,
    n_patches=1024,
    source="arXiv:2409.12191 (Qwen2-VL); hf:Qwen/Qwen2-VL-2B",
)
