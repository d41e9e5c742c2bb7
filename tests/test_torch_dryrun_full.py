"""The dry run's full-width traces against the JAX reference, on the CPU.

The prefill and one decode step of one arch a family (dense, moe,
hybrid, ssm, audio, vlm) at published widths run once on fake tensors of
the card's stand-in (``dryrun.fake_card``: here the CPU, with the
kernels' route); their outputs' shapes and dtypes are held to the
reference's ``jax.eval_shape`` of the same step (``_dryrun_ref``).
"""
import jax
import pytest
import torch

from _dryrun_ref import as_lists, cell_shape, reference_outputs
from repro.configs import ARCHS as REF_ARCHS
from repro_torch.configs import ARCHS
from repro_torch.core.config import StepKind
from repro_torch.launch import dryrun
from repro_torch.models.lm import LMModel

MESH = dryrun.one_card_mesh()


# one arch a family at published widths: a short prefill (past the vlm's
# 1024 patches) and one decode step against a short cache
FULL_WIDTH = ["qwen2-0.5b", "phi3.5-moe", "recurrentgemma-2b", "rwkv6-7b",
              "musicgen-large", "qwen2-vl-2b"]


@pytest.mark.parametrize("kind", [StepKind.PREFILL, StepKind.DECODE],
                         ids=lambda k: k.value)
@pytest.mark.parametrize("name", FULL_WIDTH)
def test_full_width_trace_outputs_match_reference_eval_shape(name, kind):
    arch, ref_arch = ARCHS[name], REF_ARCHS[name]
    shape = cell_shape(kind, arch.n_patches + 64 if arch.vlm else 64, 1)
    cfg = dryrun.cell_config(arch, shape)
    got = dryrun.trace_cell(arch, shape, MESH, cfg)
    assert as_lists(got["outputs"]) == reference_outputs(
        ref_arch, arch, shape, cfg, MESH)
    # every parameter's bytes are arguments of the step
    schema_bytes = sum(int(p.numel()) * p.element_size() for p in
                       jax.tree.leaves(dryrun.abstract_params(
                           LMModel(arch, device="meta").schema(),
                           torch.bfloat16)))
    assert got["argument_bytes"] >= schema_bytes


