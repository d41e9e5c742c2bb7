"""The dry run's depth extrapolation and its counters against real runs,
on the CPU.

The extrapolation from shallow traces (``dryrun.calibrate_costs``) is
held to a full-depth trace of reduced configs: FLOPs, bytes and the step
peak exactly. A
trace of the plain route (``kernel_mode="ref"``) on fake tensors is held
to a real CPU run of the same step under the same counters
(``dryrun.trace``): FLOPs, the peak above the arguments and the outputs
equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _dryrun_ref import cell_shape, real_like, reduced_pair
from repro_torch.configs import ARCHS
from repro_torch.core.config import StepKind
from repro_torch.core.partitioning import MeshSpec
from repro_torch.launch import dryrun
from repro_torch.launch.sharding_plan import batch_specs
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step

CPU = torch.device("cpu")
MESH = dryrun.one_card_mesh()
KINDS = (StepKind.TRAIN, StepKind.PREFILL, StepKind.DECODE)


DEPTH_CELLS = [
    ("qwen2-0.5b", {}, StepKind.TRAIN),
    ("qwen2-0.5b", {}, StepKind.PREFILL),
    ("qwen2-0.5b", {}, StepKind.DECODE),
    ("phi3.5-moe", {}, StepKind.PREFILL),
    ("rwkv6-7b", {}, StepKind.TRAIN),
    ("rwkv6-7b", {"n_layers": 5}, StepKind.TRAIN),
    ("rwkv6-7b", {}, StepKind.PREFILL),
]


@pytest.mark.parametrize("name,replace,kind", DEPTH_CELLS,
                         ids=[f"{n}-{r.get('n_layers', 'r')}-{k.value}"
                              for n, r, k in DEPTH_CELLS])
def test_depth_extrapolation_equals_the_full_depth_trace(name, replace,
                                                         kind):
    """FLOPs and bytes of a stack of identical layers, extrapolated from 1
    and 2 layers, equal a full-depth trace's; so does the step peak of a
    train or decode step, and a prefill's is over by at most two of the
    allocator's blocks."""
    arch, _ = reduced_pair(name, **replace)
    shape = cell_shape(kind, 8, 8)
    cfg = dryrun.cell_config(arch, shape)
    full = dryrun.trace_cell(arch, shape, MESH, cfg)
    cal = dryrun.calibrate_costs(arch, shape, MESH, cfg)
    assert cal["flops"] == full["flops"]
    assert cal["bytes"] == full["bytes"]
    over = cal["step_peak_bytes"] - full["step_peak_bytes"]
    if kind == StepKind.PREFILL:
        assert 0 <= over <= 2 * dryrun.ALLOC_ROUND
    else:
        assert over == 0


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "deepseek-v3"])
def test_calibration_refuses_a_stack_of_mixed_layers(name):
    """A hybrid pattern, or dense layers before fewer MoE layers than the
    calibration's first trace holds (reduced deepseek-v3: 3 dense, 1 MoE):
    no stack of identical layers to extrapolate, so traced at full
    depth."""
    arch, _ = reduced_pair(name)
    shape = cell_shape(StepKind.PREFILL, 8, 8)
    with pytest.raises(ValueError, match="identical layers"):
        dryrun.calibrate_costs(arch, shape, MESH,
                               dryrun.cell_config(arch, shape))


def test_needs_calibration_only_where_a_plain_scan_steps_by_token():
    """And, for rank 0's sharded trace, for an MoE stack with leading
    dense layers deeper than its calibration traces (deepseek-v3; not its
    reduced config, 3 dense and 1 MoE layer)."""
    shapes = {k: cell_shape(k, 8, 8) for k in KINDS}
    for name, arch in ARCHS.items():
        for kind, shape in shapes.items():
            want = arch.family == "ssm" and kind == StepKind.TRAIN
            assert dryrun.needs_calibration(arch, shape) == want
            assert dryrun.needs_calibration(arch, shape, sharded=True) == (
                want or name == "deepseek-v3")
    arch, _ = reduced_pair("deepseek-v3")
    assert not dryrun.needs_calibration(arch, shapes[StepKind.TRAIN],
                                        sharded=True)


def test_sharded_moe_calibration_equals_the_full_depth_trace():
    """Rank 0's sharded trace of reduced deepseek-v3 at 3 dense and 4 MoE
    layers on a (2, 2) mesh (experts over both axes), extrapolated from 5
    and 6 layers: bytes and every collective kind's count and bytes equal
    the full-depth trace's; the step peak, not additive, within 10% (the
    dry run's limit on the card)."""
    arch, _ = reduced_pair("deepseek-v3", n_layers=7)
    shape = cell_shape(StepKind.TRAIN, 8, 4)
    cfg = dataclasses.replace(dryrun.cell_config(arch, shape, accum=1),
                              param_dtype="float32")
    mesh = MeshSpec(("data", "model"), (2, 2), np.arange(4).reshape(2, 2))
    assert dryrun.calibration_depths(arch) == (5, 6)
    full = dryrun.trace_cell(arch, shape, mesh, cfg, sharded=True)
    cal = dryrun.calibrate_costs(arch, shape, mesh, cfg, sharded=True)
    assert cal["bytes"] == full["bytes"]
    assert cal["collectives"] == full["collectives"]
    assert full["collectives"]["all-to-all"]["count"] > 0
    assert abs(cal["step_peak_bytes"] - full["step_peak_bytes"]) <= \
        0.10 * full["step_peak_bytes"]


# ---------------------------------------------------------------------------
# a trace of the plain route against a real CPU run
# ---------------------------------------------------------------------------
REAL_CELLS = [("qwen2-0.5b", k) for k in KINDS] + [
    ("recurrentgemma-2b", StepKind.TRAIN),
    ("recurrentgemma-2b", StepKind.DECODE),
    ("phi3.5-moe", StepKind.TRAIN), ("phi3.5-moe", StepKind.PREFILL),
    ("rwkv6-7b", StepKind.PREFILL), ("musicgen-large", StepKind.TRAIN),
    ("qwen2-vl-2b", StepKind.PREFILL), ("deepseek-v3", StepKind.PREFILL)]


@pytest.mark.parametrize("name,kind", REAL_CELLS,
                         ids=[f"{n}-{k.value}" for n, k in REAL_CELLS])
def test_ref_mode_trace_equals_a_real_cpu_run(name, kind):
    arch, _ = reduced_pair(name)
    shape = cell_shape(kind, 16, 8)
    cfg = dryrun.cell_config(arch, shape)
    fake = dryrun.trace_cell(arch, shape, MESH, cfg, kernel_mode="ref")
    assert fake["trace_device"] == "cpu"

    model = LMModel(arch, remat=cfg.train.remat, kernel_mode="ref",
                    device=CPU)
    params = model.init_params(0, getattr(torch, cfg.param_dtype))
    batch = real_like(batch_specs(arch, shape, MESH)["specs"],
                      arch.vocab_size)
    if kind == StepKind.TRAIN:
        fn, args = make_train_step(model, cfg), (
            params, adamw.init(params, cfg.train), batch, 0)
    elif kind == StepKind.PREFILL:
        fn, args = model.prefill, (params, batch)
    else:
        fn, args = model.decode_step, (
            params, model.init_cache(shape.global_batch, shape.seq_len),
            batch)
    real = dryrun.trace(fn, args, CPU)
    assert real["flops"] == fake["flops"] > 0
    assert real["step_peak_bytes"] == fake["step_peak_bytes"] > 0
    assert real["outputs"] == fake["outputs"]
