"""musicgen-large: decoder-only transformer over EnCodec tokens, 4 parallel
codebook streams [arXiv:2306.05284; hf]. Modality frontend (EnCodec) is a
stub: input_specs supplies precomputed frame embeddings; the 4 codebook
heads + codebook embedding tables are real. Positional scheme adapted from
learned-sinusoidal to RoPE (documented deviation, DESIGN.md §8)."""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    act="gelu",
    rope_theta=10_000.0,
    source="arXiv:2306.05284 (MusicGen); hf:facebook/musicgen-large",
)
