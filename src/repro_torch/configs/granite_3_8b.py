"""granite-3-8b: IBM Granite 3.0 dense GQA [hf:ibm-granite/granite-3.0-8b-base]."""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-8b-base (per assignment table)",
)
