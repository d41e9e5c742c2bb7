"""The part of ``repro.core.config`` the port needs, and the device rule
every entry point of the port shares.

The paper's four axes: the placement policy drives the analytics engine;
the mesh layout (thread placement), the allocator kinds and the OS
configuration are the axes of the allocator microbenchmark and the layout
model (``memory/microbench.py``, ``core/meshes.py``). The
architecture dataclasses (``ArchConfig`` and its family configs,
``PaddedDims``) drive the LM stack. They are data, copied from the
reference so that the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch


class PlacementPolicy(enum.Enum):
    """NUMA memory-placement policies mapped to shardings (paper Section
    3.3): the distributed lowering's axis. Values match the reference."""

    FIRST_TOUCH = "first_touch"
    INTERLEAVE = "interleave"
    LOCAL_ALLOC = "local_alloc"
    PREFERRED = "preferred"


class MeshLayout(enum.Enum):
    """How logical mesh axes map onto the physical torus (paper Section
    3.2, thread placement). Values match the reference.

    NONE    device enumeration order (the "OS free to migrate" baseline).
    SPARSE  model-parallel groups spread across distinct neighbourhoods,
            maximizing aggregate link bandwidth (paper's Sparse affinity).
    DENSE   model-parallel groups packed into adjacent chips, minimizing hop
            count inside a group (paper's Dense affinity).
    """

    NONE = "none"
    SPARSE = "sparse"
    DENSE = "dense"


@dataclass(frozen=True)
class OSConfig:
    """Analogue of the paper's kernel-level switches (Section 3.4).

    ``auto_rebalance``   AutoNUMA analogue: automatically reshard live state
                         toward its policy-ideal placement between steps.
    ``page_tokens``      THP analogue for the paged KV cache: tokens per page
                         (16 = 4KB-ish small page, 512 = 2MB-ish huge page).
    ``granule_bytes``    allocation granule of the arena allocators.
    """

    auto_rebalance: bool = True          # Linux default: on (harmful, per paper)
    page_tokens: int = 512               # THP default: on (large pages)
    granule_bytes: int = 2 * 1024 * 1024

    def tuned(self) -> "OSConfig":
        """The paper's recommended configuration (AutoNUMA off, THP off)."""
        return dataclasses.replace(self, auto_rebalance=False, page_tokens=16,
                                   granule_bytes=4 * 1024)


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``device``, or the CUDA device when None. Raises when the result is
    a CUDA device and there is none: pass ``device="cpu"`` for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class AllocatorKind(enum.Enum):
    BUMP = "bump"          # ptmalloc analogue: one global region, one lock
    ARENA = "arena"        # jemalloc analogue: per-stream arenas, round robin
    SLAB = "slab"          # tbbmalloc/tcmalloc analogue: size-class slabs
    HOARD = "hoard"        # Hoard analogue: global heap + per-stream heaps


class AttentionKind(enum.Enum):
    GQA = "gqa"            # grouped-query attention (covers MHA/MQA)
    MLA = "mla"            # deepseek multi-head latent attention
    NONE = "none"          # attention-free (rwkv)
    HYBRID = "hybrid"      # recurrentgemma: RG-LRU + local attention pattern


class RopeKind(enum.Enum):
    NONE = "none"
    ROPE = "rope"
    MROPE = "mrope"        # qwen2-vl multimodal 3-section rope


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden size
    n_shared_experts: int = 0          # deepseek-style always-on experts
    n_dense_layers: int = 0            # leading layers that stay dense
    dense_d_ff: Optional[int] = None   # FFN width of the leading dense layers
    router_aux_weight: float = 0.001   # load-balancing aux loss
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma block pattern: ``pattern`` repeats over layers."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    window: int = 2048                 # local attention window
    d_rnn: Optional[int] = None        # RG-LRU width (defaults to d_model)
    conv_width: int = 4                # temporal conv1d width


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64               # rank of data-dependent decay LoRA
    mix_lora: int = 32                 # rank of token-shift mixing LoRA


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture with exact published dimensions."""

    name: str
    family: str                        # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # defaults to d_model // n_heads
    attention: AttentionKind = AttentionKind.GQA
    qk_norm: bool = False              # qwen3
    qkv_bias: bool = False             # qwen2
    rope: RopeKind = RopeKind.ROPE
    rope_theta: float = 10_000.0
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mtp: bool = False                  # deepseek multi-token prediction head
    n_codebooks: int = 0               # musicgen: parallel codebook heads
    vlm: bool = False                  # qwen2-vl: patch-embedding side input
    n_patches: int = 1024              # VLM stub: patches per example
    max_seq_len: int = 1 << 20
    source: str = ""                   # provenance citation

    # ---- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when serving cost per token does not grow with context."""
        return self.attention in (AttentionKind.NONE, AttentionKind.HYBRID)

    def param_count(self) -> int:
        """Analytic parameter count (unpadded), for 6ND roofline math."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.attention == AttentionKind.MLA:
            m = self.mla
            att = (d * m.q_lora_rank
                   + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                   + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                   + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                   + self.n_heads * m.v_head_dim * d)
        elif self.attention == AttentionKind.NONE:
            r = self.rwkv or RWKVConfig()
            att = 4 * d * d + d * (5 * r.decay_lora + 10 * r.mix_lora)  # rwkv time mix
        else:
            att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn_dense = 3 * d * self.d_ff  # swiglu: gate, up, down
        per_layer = att + ffn_dense
        total = emb + L * per_layer
        if self.moe is not None:
            moe_layers = L - self.moe.n_dense_layers
            expert_ffn = 3 * d * self.moe.d_expert
            moe_per_layer = (self.moe.n_experts + self.moe.n_shared_experts) * expert_ffn
            total = (emb + L * att + self.moe.n_dense_layers * ffn_dense
                     + moe_layers * moe_per_layer)
        if self.hybrid is not None:
            # hybrid: replace attention in rglru layers with the RG-LRU block
            h = self.hybrid
            d_rnn = h.d_rnn or d
            n_rglru = sum(1 for i in range(L) if h.pattern[i % len(h.pattern)] == "rglru")
            rglru = 2 * d * d_rnn + d_rnn * d + h.conv_width * d_rnn + 2 * d_rnn
            total += n_rglru * (rglru - att)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        moe_layers = L - self.moe.n_dense_layers
        expert_ffn = 3 * d * self.moe.d_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * expert_ffn * moe_layers
        return int(self.param_count() - inactive)



def pad_to(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return int(math.ceil(n / multiple) * multiple)


@dataclass(frozen=True)
class PaddedDims:
    """TP-divisibility padding decisions (exact-output zero padding).

    Padded query heads have zero Wq rows and zero Wo columns, so their
    contribution to the output is exactly zero; padded KV heads are only
    attended to by padded query heads. Vocab is padded to the lane
    multiple; padded logits rows are masked to -inf before the softmax.
    """

    n_heads: int
    n_kv_heads: int
    vocab_size: int
    d_ff: int

    @staticmethod
    def for_tp(arch: ArchConfig, tp: int, lane: int = 128) -> "PaddedDims":
        n_heads = pad_to(arch.n_heads, tp)
        n_kv = pad_to(arch.n_kv_heads, tp) if arch.n_kv_heads else 0
        # keep q:kv group structure intact: q heads must divide evenly by kv
        if n_kv:
            group = max(1, n_heads // n_kv)
            n_heads = n_kv * group
            while n_heads < arch.n_heads:
                group += 1
                n_heads = n_kv * group
            n_heads = pad_to(n_heads, tp)
            if n_heads % n_kv:
                n_heads = pad_to(n_heads, n_kv * tp // math.gcd(n_kv, tp))
        vocab = pad_to(arch.vocab_size, max(lane, tp))
        d_ff = pad_to(arch.d_ff, tp)
        return PaddedDims(n_heads=n_heads, n_kv_heads=n_kv, vocab_size=vocab,
                         d_ff=d_ff)
