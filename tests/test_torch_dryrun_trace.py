"""The dry run's traces of reduced configs against the JAX reference, on
the CPU.

A cell's step (the train step, the prefill, one decode step) runs once on
fake tensors of the card's stand-in (``dryrun.fake_card``: here the CPU,
with the kernels' route), for every arch at reduced size and at widths
the kernels take. Its outputs' shapes and dtypes are held to the
reference's ``jax.eval_shape`` of the same step (``_dryrun_ref``).
"""
import pytest

from _dryrun_ref import as_lists, cell_shape, reduced_pair, reference_outputs
from repro_torch.configs import ARCHS
from repro_torch.core.config import StepKind
from repro_torch.launch import dryrun

MESH = dryrun.one_card_mesh()
KINDS = (StepKind.TRAIN, StepKind.PREFILL, StepKind.DECODE)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_trace_outputs_match_reference_eval_shape(name, kind):
    arch, ref_arch = reduced_pair(name)
    # 8 rows: a multiple of every arch's accumulation (deepseek-v3's 8)
    shape = cell_shape(kind, 16, 8)
    cfg = dryrun.cell_config(arch, shape)
    got = dryrun.trace_cell(arch, shape, MESH, cfg)
    assert got["flops"] > 0 and got["bytes"] > 0
    assert got["step_peak_bytes"] > 0
    assert as_lists(got["outputs"]) == reference_outputs(
        ref_arch, arch, shape, cfg, MESH)


