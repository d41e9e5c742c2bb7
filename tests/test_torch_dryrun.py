"""The port's dry run (``repro_torch.launch.dryrun``): its configuration
and argument bytes against the JAX reference, the kernels' operators on
fake tensors, the MoE count and the CLI, on the CPU.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so the reference's ``cell_config`` and ``skip_reason`` run in
one subprocess that prints them as JSON. The argument bytes are held to
the reference's plan in-process: its shardings on a
``jax.sharding.AbstractMesh`` (no devices), each leaf's
``NamedSharding.shard_shape`` times its itemsize, exactly. The FLOP
formulas are held to ``FlopCounterMode`` over the plain attention where
both do the same products (no mask), and to a brute-force count of the
visible pairs otherwise; the scans' to their closed forms.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from _dryrun_ref import ref_cfg as as_ref_cfg
from conftest import REPO, SRC, run_with_devices
from repro.configs import ARCHS as REF_ARCHS
from repro.core import config as ref_config
from repro.core.params import abstract_params as ref_abstract
from repro.launch import sharding_plan as ref_plan
from repro.models.lm import LMModel as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import REDUCED
from repro_torch.core import config
from repro_torch.core.config import LM_SHAPES
from repro_torch.core.partitioning import MeshSpec
from repro_torch.kernels import build, common
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import _mask, attention_naive
from repro_torch.kernels.rglru_scan import linear_scan
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.lm import LMModel

CPU = torch.device("cpu")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDES = {
    "default": {},
    "first_touch": {"policy": "first_touch"},
    "local_alloc": {"policy": "local_alloc"},
    "preferred": {"policy": "preferred"},
    "no_sp": {"sequence_parallel": False},
    "accum_3": {"accum": 3},
    "accum_1": {"accum": 1},
    "fsdp": {"strategy": "fsdp"},
    "fsdp_no_sp": {"strategy": "fsdp", "sequence_parallel": False},
    "accum_bf16": {"accum_bf16": True},
    "accum_f32": {"accum_bf16": False},
}
# the reference's skip message cites a design document that is not in the
# repository; the port drops that citation and keeps the words
REF_CITATION = " (DESIGN.md §8)"

DESCRIBE = '''
import dataclasses

def describe(cfg):
    def plain(d):
        return {k: (v.value if hasattr(v, "value") else v)
                for k, v in d.items()}
    return {"arch": cfg.arch.name, "shape": cfg.shape.name,
            "train": dataclasses.asdict(cfg.train),
            "sharding": plain(dataclasses.asdict(cfg.sharding)),
            "os": dataclasses.asdict(cfg.os),
            "allocator": cfg.allocator.value,
            "param_dtype": cfg.param_dtype,
            "activation_dtype": cfg.activation_dtype}
'''
namespace: dict = {}
exec(DESCRIBE, namespace)
describe = namespace["describe"]


@pytest.fixture(scope="module")
def reference_cells():
    """{override: {arch: {shape: [described RunConfig, skip reason]}}}
    from the reference, in a subprocess."""
    code = DESCRIBE + f'''
import json
from repro.launch import dryrun
from repro.configs import ARCHS
from repro.core.config import LM_SHAPES
out = {{}}
for name, kw in {OVERRIDES!r}.items():
    out[name] = {{a: {{s: [describe(dryrun.cell_config(
        ARCHS[a], LM_SHAPES[s], **kw)), dryrun.skip_reason(
        ARCHS[a], LM_SHAPES[s])] for s in LM_SHAPES}} for a in ARCHS}}
print(json.dumps(out))
'''
    return json.loads(run_with_devices(code, n_devices=1).splitlines()[-1])


@pytest.mark.parametrize("override", list(OVERRIDES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cell_config_and_skip_reason_match_reference(reference_cells, name,
                                                     override):
    for shape in LM_SHAPES:
        want_cfg, want_skip = reference_cells[override][name][shape]
        cfg = dryrun.cell_config(ARCHS[name], LM_SHAPES[shape],
                                 **OVERRIDES[override])
        assert describe(cfg) == want_cfg, (name, shape)
        skip = dryrun.skip_reason(ARCHS[name], LM_SHAPES[shape])
        if want_skip is None:
            assert skip is None
        else:
            assert skip == want_skip.replace(REF_CITATION, "")
    assert sum(dryrun.skip_reason(ARCHS[name], s) is not None
               for s in LM_SHAPES.values()) == \
        (0 if ARCHS[name].sub_quadratic else 1)


# ---------------------------------------------------------------------------
# argument bytes per device: the sharding plan's shard shapes
# ---------------------------------------------------------------------------
def _shard_bytes(values, shardings):
    vals = jax.tree.leaves(values)
    shards = jax.tree.leaves(shardings)
    assert len(vals) == len(shards)
    return sum(int(np.prod(s.shard_shape(v.shape), dtype=np.int64))
               * jnp.dtype(v.dtype).itemsize for v, s in zip(vals, shards))


def _reference_argument_bytes(cfg, mesh):
    """Each argument group's bytes on one device under the reference's
    plan, from ``NamedSharding(AbstractMesh, spec).shard_shape``."""
    arch, shape = REF_ARCHS[cfg.arch.name], ref_config.LM_SHAPES[
        cfg.shape.name]
    ref_cfg = as_ref_cfg(cfg, arch, shape)
    # the model's padding as the reference's build_cell chooses it
    tp = (1 if cfg.sharding.strategy == "fsdp" or cfg.sharding.decode_dshard
          else mesh.shape["model"])
    model = RefLM(arch, tp=tp)
    params = ref_abstract(model.schema(), jnp.dtype(ref_cfg.param_dtype))
    out = {"params": _shard_bytes(params, ref_plan.param_shardings(
        model, ref_cfg, mesh))}
    binfo = ref_plan.batch_specs(arch, shape, mesh, cfg.sharding.strategy)
    out["batch"] = _shard_bytes(binfo["specs"], binfo["shardings"])
    if shape.kind == ref_config.StepKind.TRAIN:
        opt = ref_adamw.abstract_state(params, ref_cfg.train)
        out["opt_state"] = _shard_bytes(opt, ref_plan.opt_state_shardings(
            model, ref_cfg, mesh, params, opt))
        out["step"] = 4                    # the step counter, int32
    elif shape.kind == ref_config.StepKind.DECODE:
        B, cap = shape.global_batch, shape.seq_len
        out["cache"] = _shard_bytes(model.cache_spec(B, cap),
                                    ref_plan.cache_shardings(
                                        model, ref_cfg, mesh, B, cap))
    out["total"] = sum(out.values())
    return out


CELLS = [(a, s) for a in sorted(ARCHS) for s in LM_SHAPES
         if dryrun.skip_reason(ARCHS[a], LM_SHAPES[s]) is None]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,shape", CELLS)
def test_argument_bytes_per_device_match_reference_shard_shapes(
        name, shape, mesh_name):
    sizes, axes = MESHES[mesh_name]
    cfg = dryrun.cell_config(ARCHS[name], LM_SHAPES[shape])
    pmesh = MeshSpec(axes, sizes)
    model = LMModel(ARCHS[name], tp=dryrun.model_tp(pmesh, cfg),
                    device="meta")
    got = dryrun.argument_bytes_per_device(model, cfg, pmesh)
    want = _reference_argument_bytes(cfg, AbstractMesh(sizes, axes))
    assert got == want


@pytest.mark.parametrize("variant", ["fsdp", "decode_dshard"])
@pytest.mark.parametrize("name,shape", [("yi-34b", "train_4k"),
                                        ("deepseek-v3", "decode_32k"),
                                        ("qwen2-0.5b", "decode_32k"),
                                        ("phi3.5-moe", "prefill_32k")])
def test_argument_bytes_under_fsdp_and_decode_dshard_match_reference(
        name, shape, variant):
    sizes, axes = MESHES["16x16"]
    pmesh = MeshSpec(axes, sizes)
    cfg = dryrun.cell_config(ARCHS[name], LM_SHAPES[shape])
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, **({"strategy": "fsdp", "sequence_parallel": False}
                         if variant == "fsdp" else {"decode_dshard": True})))
    model = LMModel(ARCHS[name], tp=dryrun.model_tp(pmesh, cfg),
                    device="meta")
    got = dryrun.argument_bytes_per_device(model, cfg, pmesh)
    assert got == _reference_argument_bytes(cfg, AbstractMesh(sizes, axes))


def test_one_card_mesh_holds_every_argument_whole():
    """On the one-card mesh every leaf is whole: the bytes are the
    arguments' own."""
    cfg = dryrun.cell_config(ARCHS["qwen2-0.5b"], LM_SHAPES["train_4k"])
    mesh = dryrun.one_card_mesh()
    assert dryrun.mesh_name(mesh) == "1" and dryrun.n_chips(mesh) == 1
    model = LMModel(ARCHS["qwen2-0.5b"], device="meta")
    got = dryrun.argument_bytes_per_device(model, cfg, mesh)
    n = ARCHS["qwen2-0.5b"].param_count()
    schema_n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(
        model.schema(), is_leaf=lambda x: hasattr(x, "axes")))
    assert got["params"] == 2 * schema_n and schema_n >= n * 0.99
    # master weights, two moments in float32, and the step counter
    assert got["opt_state"] == 3 * 4 * schema_n + 4
    assert got["batch"] == 2 * 256 * 4096 * 4


# ---------------------------------------------------------------------------
# the card's stand-in: passed to the model, never a global
# ---------------------------------------------------------------------------
def test_card_stand_in_lives_only_inside_fake_card():
    """``build_cell`` gives the model the stand-in and the kernels' route;
    ``resolve_device`` and the default route are what they are outside
    the dry run, inside its fake mode too; the kernels' checks take a fake
    tensor, and only a fake one, for the card's."""
    dev = dryrun.card_stand_in()
    mesh = dryrun.one_card_mesh()
    arch = REDUCED["qwen2-0.5b"]
    shape = config.ShapeConfig("s", config.StepKind.PREFILL, 8, 2)
    with dryrun.fake_card() as fdev:
        assert fdev == dev
        model, _, args = dryrun.build_cell(arch, shape, mesh,
                                           dryrun.cell_config(arch, shape))
        assert model.device == dev and model.kernel_mode == "cuda"
        assert all(t.device == dev for t in _tensors(args))
        assert common.kernel_mode(None, CPU) == "ref"
        common.check_input(torch.empty(2, 3), "x", torch.float32, (2, 3),
                           CPU)
    with pytest.raises(ValueError, match="a CUDA device"):
        common.check_input(torch.empty(2, 3), "x", torch.float32, (2, 3),
                           CPU)
    if not torch.cuda.is_available():
        assert dev == CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.resolve_device()
        with dryrun.fake_card():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                config.resolve_device()


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_route_keeps_float32_copies_for_its_backward(
        dtype):
    """On the kernel's route (here the fake one) the kernel gets float32
    inputs and the backward recomputes from those same float32 tensors;
    the output and the gradients come back in the inputs' dtype. The plain
    route keeps the inputs as they are."""
    from repro_torch.kernels.flash_attention import flash_attention
    with dryrun.fake_card() as dev:
        q, k, v = (torch.empty(1, 8, 2, 64, device=dev, dtype=dtype,
                               requires_grad=True) for _ in range(3))
        out = flash_attention(q, k, v, mode="cuda")
        assert out.dtype == dtype
        assert [t.dtype for t in out.grad_fn.saved_tensors] == \
            [torch.float32] * 3
        out.sum().backward()
        assert q.grad.dtype == k.grad.dtype == v.grad.dtype == dtype
    q, k, v = (torch.zeros(1, 8, 2, 64, dtype=dtype, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, mode="ref")
    assert [t.dtype for t in out.grad_fn.saved_tensors] == [dtype] * 3


# ---------------------------------------------------------------------------
# the kernels' operators: FLOP formulas, fakes, no build, no launch
# ---------------------------------------------------------------------------
def _fake_flops(fn):
    """FLOPs of ``fn(device)`` run on fake tensors of the stand-in (the
    kernels' route: ``mode="cuda"``, as ``build_cell``'s model takes it)."""
    with dryrun.fake_card() as dev, FlopCounterMode(display=False) as fc:
        out = fn(dev)
    return fc.get_total_flops(), out


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [(2, 8, 12, 4, 2, 64),
                                             (1, 33, 33, 6, 3, 128),
                                             (3, 5, 40, 2, 1, 192)])
def test_flash_flop_formula_matches_flop_counter_without_a_mask(
        B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.RandomState(Sq)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    with FlopCounterMode(display=False) as fc:
        attention_naive(q, k, v, causal=False)
    want = fc.get_total_flops()
    got, out = _fake_flops(lambda dev: fa_ops._launch(
        torch.empty(B, Sq, Hq, D, device=dev),
        torch.empty(B, Skv, Hkv, D, device=dev),
        torch.empty(B, Skv, Hkv, D, device=dev), causal=False, window=None,
        q_offset=0, scale=D ** -0.5))
    assert got == want == 4 * D * B * Hq * Sq * Skv
    assert tuple(out.shape) == (B, Sq, Hq, D) and out.dtype == torch.float32


@pytest.mark.parametrize("Sq,Skv,q_offset,causal,window", [
    (16, 16, 0, True, None), (16, 16, 0, True, 5), (7, 30, 23, True, None),
    (7, 30, 23, True, 4), (9, 9, 0, False, 3), (40, 24, 0, True, None),
    (4, 64, 100, True, 8), (1, 1, 0, True, 0)])
def test_flash_flop_formula_counts_the_visible_pairs(Sq, Skv, q_offset,
                                                     causal, window):
    qpos = q_offset + torch.arange(Sq)
    pairs = int(_mask(qpos, torch.arange(Skv), causal, window).sum())
    assert fa_ops.visible_pairs(Sq, Skv, q_offset, causal, window) == pairs
    B, Hq, Hkv, D = 2, 4, 2, 64
    got, _ = _fake_flops(lambda dev: fa_ops._launch(
        torch.empty(B, Sq, Hq, D, device=dev),
        torch.empty(B, Skv, Hkv, D, device=dev),
        torch.empty(B, Skv, Hkv, D, device=dev), causal=causal,
        window=window, q_offset=q_offset, scale=0.125))
    assert got == 4 * D * B * Hq * pairs


def test_scan_flop_formulas_are_their_closed_forms():
    B, S, D = 2, 37, 24
    got, h = _fake_flops(lambda dev: linear_scan(
        torch.empty(B, S, D, device=dev), torch.empty(B, S, D, device=dev),
        mode="cuda"))
    assert got == 2 * B * S * D == scan_ops.flops((B, S, D))
    assert tuple(h.shape) == (B, S, D) and h.dtype == torch.float32

    # the backward is the same kernel, reversed: one launch more
    def fwd_bwd(dev):
        a = torch.empty(B, S, D, device=dev, requires_grad=True)
        b = torch.empty(B, S, D, device=dev, requires_grad=True)
        linear_scan(a, b, mode="cuda").sum().backward()
    got, _ = _fake_flops(fwd_bwd)
    assert got == 2 * scan_ops.flops((B, S, D))

    B, S, H, N = 2, 9, 3, 16
    got, (y, s) = _fake_flops(lambda dev: wkv6(
        *(torch.empty(B, S, H, N, device=dev) for _ in range(4)),
        torch.empty(H, N, device=dev), mode="cuda"))
    assert got == B * S * H * (5 * N * N + 5 * N) == wkv_ops.flops(
        (B, S, H, N))
    assert tuple(y.shape) == (B, S, H, N) and tuple(s.shape) == (B, H, N, N)
    assert y.dtype == s.dtype == torch.float32


def test_fake_kernels_check_their_inputs_as_the_launch_does():
    """Under the stand-in the wrappers' checks still run: a head dim the
    kernel lacks, or a dtype it does not take, raises before the
    operator."""
    with dryrun.fake_card() as dev:
        with pytest.raises(ValueError, match="head dim 16"):
            fa_ops._launch(*(torch.empty(1, 4, 2, 16, device=dev)
                             for _ in range(3)), causal=True, window=None,
                           q_offset=0, scale=0.25)
        with pytest.raises(TypeError, match="float32"):
            scan_ops._launch(torch.empty(1, 4, 8, device=dev,
                                         dtype=torch.bfloat16),
                             torch.empty(1, 4, 8, device=dev))
        with pytest.raises(ValueError, match="head size 8"):
            wkv_ops._launch(*(torch.empty(1, 4, 2, 8, device=dev)
                              for _ in range(4)),
                            torch.empty(2, 8, device=dev))


def test_a_fake_trace_builds_and_launches_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built under fake mode")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    for fn in (fa_ops._bind, scan_ops._bind):
        fn.cache_clear()
    before = dict(common.LAUNCHES)
    mesh = dryrun.one_card_mesh()
    cells = [(dataclasses.replace(REDUCED["recurrentgemma-2b"], head_dim=64),
              "train"), (REDUCED["rwkv6-7b"], "prefill"),
             (REDUCED["rwkv6-7b"], "train")]
    for arch, kind in cells:
        shape = config.ShapeConfig("s", config.StepKind(kind), 8, 2)
        out = dryrun.trace_cell(arch, shape, mesh,
                                dryrun.cell_config(arch, shape))
        assert out["flops"] > 0 and out["step_peak_bytes"] > 0
    assert common.LAUNCHES == before


# ---------------------------------------------------------------------------
# MoE: the fixed-size count; unknown families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,n_groups,hi", [(0, 4, 4), (1, 1, 1), (50, 8, 3),
                                           (1000, 64, 64), (37, 16, 16)])
def test_group_counts_equal_bincount(n, n_groups, hi):
    key = torch.from_numpy(np.random.RandomState(n).randint(0, hi, n))
    got = moe.group_counts(key, n_groups)
    want = torch.bincount(key, minlength=n_groups)
    assert got.dtype == want.dtype == torch.int64
    assert tuple(got.shape) == (n_groups,)
    assert torch.equal(got, want)
    if hi < n_groups:                             # empty groups at the end
        assert bool((got[hi:] == 0).all())


def test_moe_families_trace_on_fake_tensors():
    """The MoE layers of phi3.5-moe and deepseek-v3 (a data-dependent
    ``bincount`` before) trace: the dispatch counts are fixed-size."""
    mesh = dryrun.one_card_mesh()
    for name in ("phi3.5-moe", "deepseek-v3"):
        arch = REDUCED[name]
        if arch.mla is not None:
            arch = dataclasses.replace(
                arch, n_heads=2, n_kv_heads=2, mla=config.MLAConfig(
                    q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128))
        else:
            arch = dataclasses.replace(arch, head_dim=64)
        shape = config.ShapeConfig("s", config.StepKind.PREFILL, 16, 2)
        out = dryrun.trace_cell(arch, shape, mesh,
                                dryrun.cell_config(arch, shape))
        assert out["outputs"][0][0] == [2, 1, 128]


def test_unknown_family_is_a_value_error():
    arch = dataclasses.replace(REDUCED["qwen2-0.5b"], family="mamba")
    with pytest.raises(ValueError, match="unknown family 'mamba'"):
        LMModel(arch, device="cpu")
    for name in ARCHS:                           # every family is accepted
        LMModel(REDUCED[name], device="cpu")


# ---------------------------------------------------------------------------
# one cell on one card; the CLI
# ---------------------------------------------------------------------------
def test_run_cell_takes_a_cut_config_and_a_param_dtype():
    """``run_cell`` takes configs as well as names (a depth cut keeps its
    arch's name and reports its layers) and a parameter dtype in place of
    ``cell_config``'s; on one card ``fits`` weighs the plan's argument
    bytes plus the step peak against the device memory."""
    arch = dataclasses.replace(REDUCED["qwen2-0.5b"], head_dim=64)
    shape = config.ShapeConfig("s", config.StepKind.PREFILL, 8, 2)
    kw = dict(dryrun.H100_SXM, multi_pod=False, one_card=True,
              verbose=False)
    bf = dryrun.run_cell(arch, shape, **kw)
    f32 = dryrun.run_cell(arch, shape, param_dtype="float32", **kw)
    assert (bf["arch"], bf["n_layers"], bf["mesh"]) == (arch.name,
                                                        arch.n_layers, "1")
    assert (bf["param_dtype"], f32["param_dtype"]) == ("bfloat16",
                                                       "float32")
    assert f32["argument_bytes_per_device"]["params"] == \
        2 * bf["argument_bytes_per_device"]["params"]
    for rep in (bf, f32):
        assert rep["bytes_per_device"] == (
            rep["argument_bytes_per_device"]["total"]
            + rep["temp_bytes_per_device"])
        assert rep["fits"] is True
    tight = dryrun.run_cell(arch, shape, param_dtype="float32",
                            **dict(kw, device_memory=f32["bytes_per_device"]))
    assert tight["fits"] is False


# ---------------------------------------------------------------------------
def test_cli_traces_a_train_cell_with_no_card_and_no_allocation(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch recurrentgemma-2b
    --shape train_4k`` exits 0 on a host with no card, writes the
    reference's file name, and its process stays far below the bytes of
    the step's real arguments (5.3 GB of bf16 parameters alone); on the
    16 x 16 mesh the report has rank 0's temporaries, ``fits`` and the
    collective bytes of the sharded step, and their roofline term."""
    code = ("import resource, runpy, sys\n"
            "sys.argv = ['dryrun'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "print('maxrss_kib', resource.getrusage("
            "resource.RUSAGE_SELF).ru_maxrss)\n"
            "sys.exit(code)\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "recurrentgemma-2b",
         "--shape", "train_4k", "--out-dir", str(tmp_path)], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rss_kib = int(out.stdout.split("maxrss_kib")[-1])
    assert rss_kib < 1.5 * 2 ** 20, rss_kib
    rep = json.loads((tmp_path / "recurrentgemma-2b_train_4k_single.json")
                     .read_text())
    assert rep["status"] == "ok" and rep["mesh"] == "16x16"
    assert rep["depth"] == "full"
    for key in ("accum_steps", "policy", "strategy", "model_flops",
                "useful_flops_ratio", "flops", "flops_per_device",
                "bytes_accessed", "bytes_accessed_per_device"):
        assert rep[key] is not None, key
    assert not any(k.startswith("hlo_") for k in rep)
    assert rep["roofline"]["step_s_lower_bound"] > 0
    assert rep["roofline"]["mfu_bound"] > 0
    # rank 0 of the sharded step: its peak, and the collectives' bytes
    assert rep["temp_bytes_per_device"] > 0
    assert rep["bytes_per_device"] == (
        rep["argument_bytes_per_device"]["total"]
        + rep["temp_bytes_per_device"])
    assert rep["fits"] == (rep["bytes_per_device"] < rep["device_memory"])
    assert rep["collective_wire_bytes_per_device"] > 0
    assert rep["collective_operand_bytes_per_device"] > 0
    assert rep["roofline"]["collective_s"] == pytest.approx(
        rep["collective_wire_bytes_per_device"] / rep["rates"]["link_bw"])
    assert "temp_bytes_note" not in rep and "collectives_note" not in rep
    assert rep["rates"]["peak_flops"] == 989e12
    assert rep["model_flops"] == 6.0 * ARCHS[
        "recurrentgemma-2b"].active_param_count() * 256 * 4096


# (arch, experts): one expert a rank of each pod mesh's expert group,
# "model" for phi3.5-moe, ("data", "model") for deepseek-v3
POD_MOE = [("phi3.5-moe", 16), ("deepseek-v3", 256)]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name,n_experts", POD_MOE,
                         ids=[n for n, _ in POD_MOE])
def test_moe_cells_report_their_pod_fields(name, n_experts, multi_pod):
    """On both pod meshes the MoE families' sharded step is traced like
    every other's (a reduced config at the kernels' widths, one expert a
    rank, a prefill): temporaries, ``fits`` and collective bytes, the
    dispatch's all-to-alls among them, three an MoE layer (the tokens,
    their experts, the results back)."""
    from _dryrun_ref import kernel_widths
    arch = kernel_widths(REDUCED[name], config)
    arch = dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, n_experts=n_experts))
    shape = config.ShapeConfig("s", config.StepKind.PREFILL, 16, 32)
    rep = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False,
                          **dryrun.H100_SXM)
    assert rep["status"] == "ok"
    assert rep["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rep["temp_bytes_per_device"] > 0
    assert rep["bytes_per_device"] == (
        rep["argument_bytes_per_device"]["total"]
        + rep["temp_bytes_per_device"])
    assert rep["fits"] == (rep["bytes_per_device"] < rep["device_memory"])
    assert rep["collective_wire_bytes_per_device"] > 0
    assert rep["collective_operand_bytes_per_device"] > 0
    assert rep["roofline"]["collective_s"] > 0
    n_moe = arch.n_layers - arch.moe.n_dense_layers
    assert rep["collectives"]["all-to-all"]["count"] == 3 * n_moe
    assert rep["collectives"]["all-to-all"]["wire_bytes"] > 0
    assert not any(k.endswith("_note") for k in rep)
    assert rep["flops"] > 0
