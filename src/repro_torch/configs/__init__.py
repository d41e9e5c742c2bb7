"""Assigned architecture registry: exact published dimensions.

A copy of ``repro.configs`` as data. Every config cites its source;
padded (TP-divisible) dimensions are derived at model-build time, never
baked in here.
"""
from repro_torch.configs.yi_34b import ARCH as YI_34B
from repro_torch.configs.qwen2_0_5b import ARCH as QWEN2_0_5B
from repro_torch.configs.qwen3_1_7b import ARCH as QWEN3_1_7B
from repro_torch.configs.granite_3_8b import ARCH as GRANITE_3_8B
from repro_torch.configs.recurrentgemma_2b import ARCH as RECURRENTGEMMA_2B
from repro_torch.configs.musicgen_large import ARCH as MUSICGEN_LARGE
from repro_torch.configs.phi3_5_moe import ARCH as PHI3_5_MOE
from repro_torch.configs.deepseek_v3 import ARCH as DEEPSEEK_V3
from repro_torch.configs.qwen2_vl_2b import ARCH as QWEN2_VL_2B
from repro_torch.configs.rwkv6_7b import ARCH as RWKV6_7B

ARCHS = {
    a.name: a for a in (
        YI_34B, QWEN2_0_5B, QWEN3_1_7B, GRANITE_3_8B, RECURRENTGEMMA_2B,
        MUSICGEN_LARGE, PHI3_5_MOE, DEEPSEEK_V3, QWEN2_VL_2B, RWKV6_7B,
    )
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
