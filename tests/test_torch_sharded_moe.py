"""The MoE family on the port's sharded step (DTensor) against the
reference's ``shard_map`` expert-parallel path; tests/test_torch_sharded_
mla.py runs the same checks on the MLA family.

Reduced phi3.5-moe (8 experts, 2 a rank, on a (data 1, model 4) mesh)
here, reduced deepseek-v3 (MLA, a shared expert, the MTP head; 4 experts
over ("data", "model") on a (2, 2) mesh with ``expert_parallel_data``)
there, each at a capacity factor that drops nothing and at one that
drops at least half the assignments, run on 4 gloo ranks
(``tests/_torch_sharded_moe_worker.py``) and, in one subprocess on 4 fake
CPU devices, through the reference's ``LMModel(moe_mesh=mesh,
expert_axes=..., sequence_parallel=True)`` on the same numpy parameters
and batch:
- the forward's logits and aux loss within 1e-5;
- the loss within 1e-5 relative and each gradient leaf within 1e-3
  relative L2 of the reference's ``jax.grad(loss_fn)`` on that path (it
  runs under the installed jax);
- where nothing drops, 4 decode steps on DTensors (the one-device
  dispatch, the expert weights left split) within 2e-3 of the reference's
  forward;
- the dry run's fake-group trace of rank 0 of the family's train cell
  (accumulation 4, 8 for deepseek-v3) against gloo rank 0's real step
  under the same counters: the step peak within two 512-byte blocks, the
  same collectives by kind, count and bytes, the all-to-alls included.
The placement grid and the pod-mesh reports of both families are in
tests/test_torch_sharded.py and tests/test_torch_dryrun.py.
"""
import os
import subprocess
import sys
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import run_with_devices
from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core.params import init_params as ref_init
from repro.models.lm import LMModel as RefLM
from repro_torch.launch import dryrun

sys.path.insert(0, os.path.dirname(__file__))
import _torch_sharded_moe_worker as W  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
GLOO_JOIN_S = 600

REF_SHARDED = r'''
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.reduced import REDUCED
from repro.models.lm import LMModel
sys.path.insert(0, TESTS)
import _torch_sharded_moe_worker as W

data = dict(np.load(IN_PATH))
out = {}
for tag in W.CASES[FAMILY]:
    arch, sizes, axes = W.case_arch(tag, REDUCED)
    cf = arch.moe.capacity_factor
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes),
                ("data", "model"))
    model = LMModel(arch, tp=sizes[1], sequence_parallel=True,
                    moe_mesh=mesh, expert_axes=axes)
    p = {}
    for k, v in data.items():
        if k.startswith(tag + "|"):
            node = p
            keys = k.split("|", 1)[1].split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = jnp.asarray(v)
    b = {k: jnp.asarray(v) for k, v in W.batch(arch).items()}
    logits, _, aux = jax.jit(model.forward)(p, {"tokens": b["tokens"]})
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, b)[0]))
    loss, grads = loss_grad(p)
    out[tag + "|logits"] = np.asarray(logits)
    if cf < 4.0:                # the same model where nothing drops
        whole = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=4.0))
        out[tag + "|logits_cf4"] = np.asarray(jax.jit(LMModel(
            whole, tp=sizes[1], sequence_parallel=True, moe_mesh=mesh,
            expert_axes=model.expert_axes).forward)(
            p, {"tokens": b["tokens"]})[0])
    out[tag + "|aux"] = np.asarray(aux)
    out[tag + "|loss"] = np.asarray(loss)
    for k, g in W.flat(jax.tree.map(np.asarray, grads)).items():
        out[tag + "|grad|" + k] = g
np.savez(OUT_PATH, **out)
'''


def _params(family):
    """The reference's seeded parameters of every case, as numpy."""
    arrays = {}
    for i, tag in enumerate(W.CASES[family]):
        arch, sizes, _ = W.case_arch(tag, REF_REDUCED)
        p = ref_init(RefLM(arch, tp=sizes[1]).schema(),
                     jax.random.PRNGKey(i), jnp.float32)
        arrays.update({f"{tag}|{k}": np.asarray(v)
                       for k, v in W.flat(p).items()})
    return arrays


def family_runs(family, tmp_path_factory):
    """(the family, gloo rank 0's npz, the reference's npz): the 4 gloo
    processes and the reference's subprocess run side by side."""
    d = tmp_path_factory.mktemp("sharded_moe")
    inp = d / "in.npz"
    np.savez(inp, **_params(family))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore::FutureWarning")
    worker = os.path.join(REPO, "tests", "_torch_sharded_moe_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(W.N_RANKS), str(d / "store"),
         str(inp), str(d / "out.npz"), family], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(W.N_RANKS)]
    ref_out = d / "ref.npz"
    ref_err = []

    def reference():
        try:
            run_with_devices(
                REF_SHARDED.replace("TESTS", repr(os.path.dirname(__file__)))
                .replace("IN_PATH", repr(str(inp)))
                .replace("OUT_PATH", repr(str(ref_out)))
                .replace("FAMILY", repr(family)), n_devices=4, timeout=600)
        except BaseException as e:      # re-raised below
            ref_err.append(e)
    ref_thread = threading.Thread(target=reference)
    ref_thread.start()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GLOO_JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ref_thread.join()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    if ref_err:
        raise ref_err[0]
    return family, dict(np.load(d / "out.npz")), dict(np.load(ref_out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs("phi3.5-moe", tmp_path_factory)


def test_forward_matches_the_reference_shard_map(runs):
    family, got, want = runs
    for tag in W.CASES[family]:
        np.testing.assert_allclose(got[f"{tag}|logits"],
                                   want[f"{tag}|logits"], atol=1e-5,
                                   rtol=1e-5, err_msg=tag)
        np.testing.assert_allclose(got[f"{tag}|aux"], want[f"{tag}|aux"],
                                   atol=1e-5, rtol=1e-5, err_msg=tag)


def test_loss_and_grads_match_the_reference_jax_grad(runs):
    family, got, want = runs
    for tag in W.CASES[family]:
        np.testing.assert_allclose(got[f"{tag}|loss"], want[f"{tag}|loss"],
                                   rtol=1e-5, err_msg=tag)
        keys = [k for k in want if k.startswith(f"{tag}|grad|")]
        assert keys and sorted(keys) == sorted(
            k for k in got if k.startswith(f"{tag}|grad|"))
        for k in keys:
            g, w = got[k].astype(np.float64), want[k].astype(np.float64)
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 1e-3, (k, err)


def test_decode_on_dtensors_matches_the_reference_forward(runs):
    family, got, want = runs
    tags = [t for t in W.CASES[family] if f"{t}|decode0" in got]
    assert tags
    for tag in tags:
        full = want[f"{tag}|logits"]
        for i in range(W.DECODE_STEPS):
            np.testing.assert_allclose(got[f"{tag}|decode{i}"],
                                       full[:, i:i + 1], atol=2e-3,
                                       rtol=2e-3, err_msg=f"{tag} {i}")


def test_the_dropping_cases_drop(runs):
    """At factor 0.5 the dispatch drops: the logits part from the
    reference's at factor 4.0 on the same parameters."""
    family, got, want = runs
    tags = [t for t, case in W.CASES[family].items() if case[-1] < 4.0]
    assert tags
    for tag in tags:
        assert not np.allclose(got[f"{tag}|logits"],
                               want[f"{tag}|logits_cf4"], atol=1e-3), tag


def test_fake_group_trace_is_what_gloo_rank_0_did(runs):
    """The fake-group trace of rank 0 of the family's train cell (the
    plain route, as the CPU runs it) against rank 0's real step under the
    same counters, the dispatch's all-to-alls among its collectives."""
    family, got, _ = runs
    arch, shape, cfg, mesh = W.traced_cell(family)
    trace = dryrun.trace_cell(arch, shape, mesh, cfg, kernel_mode="ref",
                              sharded=True)
    real_peak = int(got["trace|step_peak_bytes"])
    assert abs(trace["step_peak_bytes"] - real_peak) <= \
        2 * dryrun.ALLOC_ROUND
    real = [(k, float(b), int(g)) for k, b, g in got["trace|collectives"]]
    assert Counter(trace["collective_records"]) == Counter(real)
    assert trace["collectives"] == dryrun.collective_bytes(real)
    assert trace["collectives"]["all-to-all"]["count"] > 0
