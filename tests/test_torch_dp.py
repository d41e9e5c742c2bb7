"""The port's data-parallel train step, gradient compression and
``torch.distributed`` communicator against the JAX reference on the CPU.

The reference's multi-device work runs once, in one subprocess with 4
fake CPU devices (``run_with_devices``): ``compressed_psum`` under
``shard_map`` on 3 and 4 devices, and 3 compressed ``make_dp_train_step``
steps of reduced qwen2-0.5b and reduced recurrentgemma-2b on 4 devices,
jitted as the reference's own test jits them, with each device's
error-feedback residual read from the output's ``addressable_shards``.
The port runs the same inputs on a 4-rank ``VirtualMesh``.

Tolerances:
  * quantization and the compressed psum: bit for bit (``jnp.round`` and
    ``torch.round`` both round half to even; the reference under jit);
  * the DP step's losses: rtol 1e-5. A rank's gradients here agree with
    the reference's to ~1e-5 of each leaf's largest |grad| (1e-4 through
    the RG-LRU scan), and an int8 value flips where its target lies
    within that round-off of a rounding boundary: with a block scale of
    1/127 of the block's largest |value|, at up to ~2 x 127 x 1e-5 =
    2.5e-3 of the values a step. So the parameters are held within 2 x
    the summed learning rates everywhere (one Adam step moves a weight by
    at most ~lr, flips included) and within 1% of one step's lr at all
    but FLIP_SHARE = 5e-3 of the elements (counted over the whole tree).
  * each rank's residual: a residual moves with its target, the gradient
    plus the last residual, so it parts from the reference's as the
    gradients part, in units of a leaf's largest |residual| (~1/254 of its
    largest |grad|) by up to ~254 x 1e-4 a step: held within
    RESID_TOL = 5e-2 of the leaf's largest |residual| at all but
    FLIP_SHARE of the rank's elements (measured: medians 4e-5 to 2e-3,
    99th percentiles up to 1.7e-2; past that the flips, where the
    residual moves by one block scale, ~2x the largest |residual|). Each
    rank's residual is also held far closer to its own device's than to
    the next device's.

The gloo checks spawn 4 processes (``tests/_torch_dist_worker.py``), each
with a join timeout and a group timeout, and hold what they return to the
virtual mesh's bits: every collective in float32, int32 and int64, a
compressed psum in chunks of one block, and two compressed DP steps.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from conftest import REPO, SRC, run_with_devices
from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core import config as ref_config
from repro.core.params import abstract_params as ref_abstract
from repro.models.lm import LMModel as RefLM
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedules as ref_schedules
from repro_torch.configs.reduced import REDUCED
from repro_torch.core import config
from repro_torch.core.dist import DistCommunicator, DistMesh
from repro_torch.core.params import abstract_params
from repro_torch.core.vmesh import VirtualMesh
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw, compression
from repro_torch.runtime import dp_step, train_loop

CPU = torch.device("cpu")
N = 4
DP_ARCHS = ("qwen2-0.5b", "recurrentgemma-2b")
DP_STEPS, DP_B, DP_S, DP_LR = 3, 8, 16, 1e-3
FLIP_SHARE = 5e-3
RESID_TOL = 5e-2
GLOO_JOIN_S = 120


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def t(x):
    return torch.from_numpy(np.array(x))


def npf(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _cp_inputs(n, seed=0):
    """Per-device grads and residuals of the compressed-psum check: a leaf
    that is not a whole number of blocks and one of mixed scales."""
    rng = np.random.RandomState(seed + n)
    g = {"a": (rng.randn(n, 37, 29) * 1e-3).astype(np.float32),
         "b": (rng.randn(n, 3, 700) * np.exp(rng.randn(n, 3, 700))
               ).astype(np.float32)}
    e = {"a": (rng.randn(n, 37, 29) * 1e-5).astype(np.float32),
         "b": (rng.randn(n, 3, 700) * 1e-2).astype(np.float32)}
    return g, e


REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.reduced import REDUCED
from repro.core.config import LM_SHAPES, RunConfig, ShardingConfig, TrainConfig
from repro.models.lm import LMModel
from repro.optim import adamw
from repro.optim.compression import compressed_psum
from repro.runtime.dp_step import init_error_feedback, make_dp_train_step

inp = dict(np.load(IN_PATH))
out = {}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k in sorted(tree):
            o.update(flat(tree[k], prefix + k + "/"))
        return o
    return {prefix.rstrip("/"): tree}


for n in (3, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    def part(ga, gb, ea, eb):
        s, e = compressed_psum({"a": ga[0], "b": gb[0]}, "d",
                               {"a": ea[0], "b": eb[0]})
        return s["a"][None], s["b"][None], e["a"][None], e["b"][None]
    f = jax.jit(shard_map(part, mesh=mesh, in_specs=(P("d"),) * 4,
                          out_specs=(P("d"),) * 4, check_rep=False))
    res = f(*(jnp.asarray(inp[f"cp{n}/{k}"]) for k in ("ga", "gb", "ea", "eb")))
    for k, v in zip(("sa", "sb", "ea", "eb"), res):
        out[f"cp{n}/{k}"] = np.asarray(v)

mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
devs = list(mesh.devices.reshape(-1))
# every state leaf starts replicated over the mesh, as the step's outputs
# are, so the step compiles once
repl = NamedSharding(mesh, P())
for name in DP_ARCHS:
    arch = REDUCED[name]
    model = LMModel(arch, tp=1, remat="none")
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    sharding=ShardingConfig(gradient_compression=True),
                    train=TrainConfig(learning_rate=DP_LR, warmup_steps=1))
    params = {}
    for k, v in inp.items():
        if k.startswith(name + "/init/"):
            node = params
            parts = k[len(name + "/init/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
    opt = adamw.init(params, cfg.train)
    errors = init_error_feedback(params)
    params, opt, errors = jax.device_put((params, opt, errors), repl)
    step = jax.jit(make_dp_train_step(model, cfg, mesh, total_steps=DP_STEPS))
    for s in range(DP_STEPS):
        b = {k: jnp.asarray(inp[f"batch{s}/{name}/{k}"])
             for k in ("tokens", "labels")}
        params, opt, errors, m = step(params, opt, errors, b, jnp.asarray(s))
        out[f"{name}/loss{s}"] = np.asarray(m["loss"])
    for k, v in flat(params).items():
        out[f"{name}/params/{k}"] = np.asarray(v)
    for k, v in flat(errors).items():
        for sh in v.addressable_shards:
            out[f"{name}/errors{devs.index(sh.device)}/{k}"] = np.asarray(
                sh.data)
np.savez(OUT_PATH, **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's compressed psums and DP runs (one subprocess)."""
    from repro_torch.data.pipeline import synth_batch
    d = tmp_path_factory.mktemp("dp_ref")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    arrays = {}
    for n in (3, 4):
        g, e = _cp_inputs(n)
        arrays.update({f"cp{n}/ga": g["a"], f"cp{n}/gb": g["b"],
                       f"cp{n}/ea": e["a"], f"cp{n}/eb": e["b"]})
    for name in DP_ARCHS:
        # the port's seeded init, as numpy, for both packages
        init = LMModel(REDUCED[name], device=CPU).init_params(seed=3)
        arrays.update({f"{name}/init/{k}": npf(v)
                       for k, v in flat(init).items()})
        for s in range(DP_STEPS):
            for k, v in synth_batch(REDUCED[name], DP_B, DP_S, step=s,
                                    seed=7).items():
                arrays[f"batch{s}/{name}/{k}"] = v
    np.savez(inp, **arrays)
    run_with_devices(REF_SCRIPT.replace("IN_PATH", repr(inp))
                     .replace("OUT_PATH", repr(outp))
                     .replace("DP_ARCHS", repr(DP_ARCHS))
                     .replace("DP_STEPS", repr(DP_STEPS))
                     .replace("DP_LR", repr(DP_LR)),
                     n_devices=N, timeout=300)
    return arrays, dict(np.load(outp))


# ---------------------------------------------------------------------------
# quantization and the compressed psum
# ---------------------------------------------------------------------------
QUANT_CASES = {"whole blocks": (4, 256), "a padded tail": (37, 29),
               "mixed scales": (3, 700), "a zero block": (2, 256),
               "block 64": (5, 100)}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_matches_reference_under_jit(case):
    shape = QUANT_CASES[case]
    block = 64 if case == "block 64" else 256
    rng = np.random.RandomState(len(case))
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 2)).astype(
        np.float32)
    if case == "a zero block":
        x[0] = 0.0
    rq, rs = jax.jit(lambda a: ref_comp.quantize_int8(a, block))(
        jnp.asarray(x))
    q, s = compression.quantize_int8(t(x), block)
    np.testing.assert_array_equal(npf(q), np.asarray(rq))
    np.testing.assert_array_equal(npf(s), np.asarray(rs))
    rd = jax.jit(lambda q, s: ref_comp.dequantize_int8(q, s, shape, block))(
        rq, rs)
    np.testing.assert_array_equal(
        npf(compression.dequantize_int8(q, s, shape, block)), np.asarray(rd))


@pytest.mark.parametrize("n", [3, 4])
def test_compressed_psum_matches_reference(ref, n):
    arrays, want = ref
    g = {"a": arrays[f"cp{n}/ga"], "b": arrays[f"cp{n}/gb"]}
    e = {"a": arrays[f"cp{n}/ea"], "b": arrays[f"cp{n}/eb"]}
    inputs = [({k: t(v[i]) for k, v in g.items()},
               {k: t(v[i]) for k, v in e.items()}) for i in range(n)]
    outs = VirtualMesh(n, CPU, timeout=60).run(
        lambda comm, a: compression.compressed_psum(a[0], comm, a[1]),
        inputs)
    for i, (synced, errors) in enumerate(outs):
        for k in ("a", "b"):
            np.testing.assert_array_equal(npf(synced[k]),
                                          want[f"cp{n}/s{k}"][i])
            np.testing.assert_array_equal(npf(errors[k]),
                                          want[f"cp{n}/e{k}"][i])
            # the residuals are the inputs' own tensors, updated in place
            assert errors[k] is inputs[i][1][k]


def test_chunked_compression_is_the_unchunked_bits(monkeypatch):
    """Chunks of rows (down to one block) and a leaf whose memory layout
    is not row-major give the same bits as one row-major pass."""
    rng = np.random.RandomState(5)
    shapes = {"rows of 64": (40, 64), "rows of 29": (37, 29),
              "rows of 700": (3, 700), "flat": (1000,), "3-d": (6, 4, 96)}
    g = {k: (rng.randn(3, *v) * np.exp(rng.randn(3, *v))).astype(np.float32)
         for k, v in shapes.items()}
    e = {k: (rng.randn(*v.shape) * 1e-2).astype(np.float32)
         for k, v in g.items()}

    def run(transposed=False):
        def grad(x):
            x = t(x)
            # the same values in a column-major layout
            return x.t().contiguous().t() if transposed and x.dim() == 2 \
                else x
        inputs = [({k: grad(v[i]) for k, v in g.items()},
                   {k: t(v[i]) for k, v in e.items()}) for i in range(3)]
        return VirtualMesh(3, CPU, timeout=60).run(
            lambda comm, a: {k: compression.compress_leaf(
                a[0][k], a[1][k], comm, out=a[0][k]) for k in shapes},
            inputs)
    whole, strided = run(), run(transposed=True)
    monkeypatch.setattr(compression, "CHUNK_BLOCKS", 1)
    assert len(compression.row_chunks(shapes["rows of 64"])) == 10
    chunked, both = run(), run(transposed=True)
    for outs in (strided, chunked, both):
        for w, c in zip(whole, outs):
            for k in shapes:
                for x, y in zip(w[k], c[k]):
                    assert torch.equal(x, y), k


def test_compress_leaf_writes_over_its_output_and_checks_the_residual():
    g = torch.randn(3, 300)
    target = g.clone()
    e = torch.zeros(3, 300)
    synced, resid = VirtualMesh(1, CPU).run(
        lambda comm, _: compression.compress_leaf(g, e, comm, out=g),
        [None])[0]
    assert synced is g and resid is e
    # at n = 1 the synced value is this rank's dequantization, the
    # residual what it lost (rounded once), at most half a scale
    q, s = compression.quantize_int8(target)
    scale = s.repeat_interleave(256)[:900].view(3, 300)
    deq = compression.dequantize_int8(q, s, (3, 300))
    assert torch.equal(synced, deq)
    assert torch.equal(e, (target.double() - q[:900].double().view(3, 300)
                           * scale.double()).float())
    assert bool((e.abs() <= scale / 2).all())
    with pytest.raises(ValueError, match="contiguous float32"):
        VirtualMesh(1, CPU).run(lambda comm, _: compression.compress_leaf(
            g, e.double(), comm), [None])


# ---------------------------------------------------------------------------
# the DP step against the reference
# ---------------------------------------------------------------------------
def _port_dp(name, arrays):
    """The port's compressed DP run on the reference run's inputs."""
    arch = REDUCED[name]
    model = LMModel(arch, remat="none", device=CPU)
    cfg = config.RunConfig(
        arch=arch, shape=config.LM_SHAPES["train_4k"],
        sharding=config.ShardingConfig(gradient_compression=True),
        train=config.TrainConfig(learning_rate=DP_LR, warmup_steps=1))
    params = unflat({k[len(f"{name}/init/"):]: t(v) for k, v in
                     arrays.items() if k.startswith(f"{name}/init/")})
    opt = adamw.init(params, cfg.train)
    mesh = VirtualMesh(N, CPU, timeout=120)
    errors = dp_step.init_error_feedback(params, mesh)
    step = dp_step.make_dp_train_step(model, cfg, mesh, total_steps=DP_STEPS)
    losses = []
    for s in range(DP_STEPS):
        b = {k: t(arrays[f"batch{s}/{name}/{k}"]) for k in ("tokens",
                                                            "labels")}
        params, opt, errors, m = step(params, opt, errors, b, s)
        losses.append(float(m["loss"]))
    return losses, params, errors


def ref_schedule(step):
    """The reference's lr at ``step`` of the DP runs."""
    return ref_schedules.warmup_cosine(jnp.asarray(step), peak_lr=DP_LR,
                                       warmup_steps=1, total_steps=DP_STEPS)


def _off(got, want, atol):
    """(elements farther apart than atol, elements)."""
    return int((np.abs(got - want) > atol).sum()), got.size


@pytest.mark.parametrize("name", DP_ARCHS)
def test_dp_step_matches_reference(ref, name):
    arrays, want = ref
    losses, params, errors = _port_dp(name, arrays)
    np.testing.assert_allclose(
        losses, [float(want[f"{name}/loss{s}"]) for s in range(DP_STEPS)],
        rtol=1e-5)
    lr_sum = sum(float(np.asarray(ref_schedule(s)))
                 for s in range(DP_STEPS))
    off = np.zeros(2, np.int64)
    for k, v in flat(params).items():
        w = want[f"{name}/params/{k}"]
        assert float(np.abs(npf(v) - w).max()) <= 2 * lr_sum, k
        off += _off(npf(v), w, 1e-2 * DP_LR)
    assert off[0] <= FLIP_SHARE * off[1], off
    assert isinstance(errors, list) and len(errors) == N
    for r, tree in enumerate(errors):
        off = np.zeros(2, np.int64)
        own = other = 0.0
        for k, v in flat(tree).items():
            w = want[f"{name}/errors{r}/{k}"]
            top = max(1e-30, float(np.abs(w).max()))
            off += _off(npf(v), w, RESID_TOL * top)
            own += float(np.abs(npf(v) - w).sum()) / top
            other += float(np.abs(npf(v) - want[
                f"{name}/errors{(r + 1) % N}/{k}"]).sum()) / top
        assert off[0] <= FLIP_SHARE * off[1], (r, off)
        # rank r holds device r's residual, not its neighbour's
        assert own < 0.05 * other, (r, own, other)


def test_one_rank_dp_step_is_the_train_steps_bits():
    arch = REDUCED["qwen2-0.5b"]
    model = LMModel(arch, remat="none", device=CPU)
    cfg = config.RunConfig(arch=arch, shape=config.LM_SHAPES["train_4k"],
                           train=config.TrainConfig(learning_rate=DP_LR,
                                                    warmup_steps=1))
    from repro_torch.data.pipeline import synth_batch
    b = {k: t(v) for k, v in synth_batch(arch, 4, 16, step=0,
                                         seed=3).items()}
    p1 = model.init_params(1)
    o1 = adamw.init(p1, cfg.train)
    p1, o1, m1 = train_loop.make_train_step(model, cfg)(p1, o1, b, 1)
    p2 = model.init_params(1)
    o2 = adamw.init(p2, cfg.train)
    p2, o2, e2, m2 = dp_step.make_dp_train_step(
        model, cfg, VirtualMesh(1, CPU))(p2, o2, None, b, 1)
    assert e2 is None and torch.equal(m1["loss"], m2["loss"])
    for (k, a), (_, c) in zip(flat(p1).items(), flat(p2).items()):
        assert torch.equal(a, c), k


def test_four_rank_dp_step_matches_one_rank_on_the_whole_batch(
        monkeypatch):
    """Without compression the mean of 4 blocks' mean losses and grads is
    the whole batch's, up to float32 sum order: the synced gradients that
    reach AdamW within 1e-5 of each leaf's largest |grad|, and the
    parameters after the step within 1% of its lr at all but FLIP_SHARE
    of the elements (Adam's first step moves a weight by about lr times
    its gradient's sign, which flips only where a gradient is ~0)."""
    seen = []
    update = adamw.update

    def capture(grads, *a):
        seen.append({k: v.clone() for k, v in flat(grads).items()})
        return update(grads, *a)
    monkeypatch.setattr(adamw, "update", capture)
    arch = REDUCED["recurrentgemma-2b"]
    model = LMModel(arch, remat="none", device=CPU)
    cfg = config.RunConfig(arch=arch, shape=config.LM_SHAPES["train_4k"],
                           train=config.TrainConfig(learning_rate=DP_LR,
                                                    warmup_steps=1))
    from repro_torch.data.pipeline import synth_batch
    b = {k: t(v) for k, v in synth_batch(arch, 8, 16, step=0,
                                         seed=4).items()}
    p1 = model.init_params(2)
    o1 = adamw.init(p1, cfg.train)
    _, _, m1 = train_loop.make_train_step(model, cfg)(p1, o1, b, 1)
    p2 = model.init_params(2)
    o2 = adamw.init(p2, cfg.train)
    _, _, _, m2 = dp_step.make_dp_train_step(
        model, cfg, VirtualMesh(N, CPU, timeout=60))(p2, o2, None, b, 1)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(npf(m2[k]), npf(m1[k]), rtol=1e-5)
    g1, g2 = seen
    assert g1.keys() == g2.keys()
    for k in g1:
        top = float(g1[k].abs().max())
        np.testing.assert_allclose(npf(g2[k]), npf(g1[k]), rtol=0,
                                   atol=1e-5 * top, err_msg=k)
    off = np.zeros(2, np.int64)
    for (k, a), (_, c) in zip(flat(p1).items(), flat(p2).items()):
        off += _off(npf(c), npf(a), 1e-2 * DP_LR)
    assert off[0] <= FLIP_SHARE * off[1], off


def test_dp_step_checks_its_batch_and_residuals():
    arch = REDUCED["qwen2-0.5b"]
    model = LMModel(arch, remat="none", device=CPU)
    cfg = config.RunConfig(arch=arch, shape=config.LM_SHAPES["train_4k"],
                           sharding=config.ShardingConfig(
                               gradient_compression=True))
    params = model.init_params(0)
    mesh = VirtualMesh(N, CPU, timeout=10)
    step = dp_step.make_dp_train_step(model, cfg, mesh)
    b = {"tokens": torch.zeros(6, 4, dtype=torch.int32),
         "labels": torch.zeros(6, 4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="does not split"):
        step(params, adamw.init(params, cfg.train),
             dp_step.init_error_feedback(params, mesh), b, 0)
    b = {k: v[:4] for k, v in b.items()}
    with pytest.raises(ValueError, match="residual trees"):
        step(params, adamw.init(params, cfg.train),
             dp_step.init_error_feedback(params), b, 0)
    errs = dp_step.init_error_feedback(params, mesh)
    assert len(errs) == N and all(
        v.dtype == torch.float32 and not bool(v.any())
        for tree in errs for v in flat(tree).values())


@pytest.mark.parametrize("master", [True, False])
def test_abstract_state_matches_reference(master):
    arch = REDUCED["qwen2-0.5b"]
    tcfg = config.TrainConfig(moment_dtype="bfloat16", master_weights=master)
    got = adamw.abstract_state(
        abstract_params(LMModel(arch, device=CPU).schema()), tcfg)
    want = ref_adamw.abstract_state(
        ref_abstract(RefLM(REF_REDUCED["qwen2-0.5b"]).schema(),
                     jnp.bfloat16),
        ref_config.TrainConfig(moment_dtype="bfloat16",
                               master_weights=master))
    assert got.step.device.type == "meta" and got.step.dtype == torch.int32
    for field in ("mu", "nu", "master"):
        g, w = getattr(got, field), getattr(want, field)
        if not master and field == "master":
            assert g is None and w is None
            continue
        w = flat(jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), w,
                              is_leaf=lambda s: hasattr(s, "shape")))
        g = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in flat(g).items()}
        assert g == w and all(v.device.type == "meta"
                              for v in flat(getattr(got, field)).values())


# ---------------------------------------------------------------------------
# the communicator over gloo, 4 processes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each rank's npz of the gloo worker (4 spawned processes)."""
    d = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore::FutureWarning")
    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(W.N_RANKS), str(d / "store"),
         str(d / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(W.N_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GLOO_JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    return [dict(np.load(d / f"out{r}.npz")) for r in range(W.N_RANKS)]


@pytest.fixture(scope="module")
def virtual_collectives():
    mesh = VirtualMesh(W.N_RANKS, CPU, timeout=60)

    def run(comm, _):
        return {f"{op}/{name}": getattr(comm, op)(t(x)).numpy()
                for name, x in W.inputs(comm.rank).items()
                for op in W.COLLECTIVES}
    return mesh.run(run, [None] * W.N_RANKS)


@pytest.mark.parametrize("dtype", list(W.DTYPES))
@pytest.mark.parametrize("op", W.COLLECTIVES)
def test_gloo_collective_is_the_virtual_meshs_bits(gloo, virtual_collectives,
                                                   op, dtype):
    for r in range(W.N_RANKS):
        got, want = gloo[r][f"{op}/{dtype}"], virtual_collectives[r][
            f"{op}/{dtype}"]
        assert got.dtype == want.dtype == W.DTYPES[dtype]
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (op, dtype, r)


def test_gloo_psum_in_chunks_keeps_bits_and_layout(gloo):
    """A float psum gathered a few values (contiguous) or a row (any other
    layout) at a time gives the virtual mesh's bits in its input's
    layout."""
    def run(comm, _):
        return {k: comm.psum(x) for k, x in
                W.chunked_inputs(comm.rank).items()}
    outs = VirtualMesh(W.N_RANKS, CPU, timeout=60).run(run,
                                                       [None] * W.N_RANKS)
    for r, want in enumerate(outs):
        for k, v in want.items():
            assert gloo[r][f"chunked/{k}"].tobytes() == \
                v.contiguous().numpy().tobytes(), (k, r)
            x = W.chunked_inputs(r)[k]
            assert tuple(gloo[r][f"chunked/{k}/stride"]) == x.stride(), k


def test_gloo_compressed_psum_is_the_virtual_meshs_bits(gloo):
    def run(comm, _):
        g, e = W.grads(comm.rank)
        errors = W.tree(e)
        synced, _ = compression.compressed_psum(W.tree(g), comm, errors)
        return W.flat(synced), W.flat(errors)
    outs = VirtualMesh(W.N_RANKS, CPU, timeout=60).run(run,
                                                       [None] * W.N_RANKS)
    for r, (synced, errors) in enumerate(outs):
        for k in synced:
            assert gloo[r][f"cp/synced/{k}"].tobytes() == synced[k].tobytes()
            assert gloo[r][f"cp/errors/{k}"].tobytes() == errors[k].tobytes()


def test_gloo_dp_steps_are_the_virtual_meshs_bits(gloo):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, cfg, params, opt, batches = W.dp_setup()
        mesh = VirtualMesh(W.N_RANKS, CPU, timeout=60)
        step = dp_step.make_dp_train_step(model, cfg, mesh,
                                          total_steps=W.DP_STEPS)
        errs = dp_step.init_error_feedback(params, mesh)
        for s, b in enumerate(batches):
            params, opt, errs, m = step(params, opt, errs, b, s)
            for r in range(W.N_RANKS):
                assert gloo[r][f"dp/loss{s}"].tobytes() == \
                    m["loss"].numpy().tobytes()
    finally:
        torch.set_num_threads(threads)
    for r in range(W.N_RANKS):
        for k, v in W.flat(params).items():
            assert gloo[r][f"dp/params/{k}"].tobytes() == v.tobytes(), k
        for k, v in W.flat(errs[r]).items():
            assert gloo[r][f"dp/errors/{k}"].tobytes() == v.tobytes(), k


def test_gloo_traffic_and_errors(gloo):
    traffic = dict(eval(str(gloo[0]["traffic"])))
    # float psums gather, integer psums all-reduce, all-to-alls go as one
    assert set(traffic) == {"all_gather_into_tensor", "all_reduce",
                            "all_to_all_single"}
    assert all(v["calls"] > 0 and v["bytes"] > 0 for v in traffic.values())
    assert "do not split into 4" in str(gloo[0]["ragged_error"])


def test_one_rank_gloo_dp_step_is_the_train_steps_bits(tmp_path):
    """Over a torch.distributed group of one rank the uncompressed DP step
    is train_loop's step bit for bit: the psum keeps each grad's memory
    layout, so AdamW's global norm adds in the same order."""
    import torch.distributed as dist
    from repro_torch.core.dist import process_group
    arch = REDUCED["recurrentgemma-2b"]
    model = LMModel(arch, device=CPU)
    cfg = config.RunConfig(arch=arch, shape=config.LM_SHAPES["train_4k"],
                           train=config.TrainConfig(warmup_steps=2))
    from repro_torch.data.pipeline import synth_batch
    b = {k: t(v) for k, v in synth_batch(arch, 1, 32, step=1).items()}
    p1 = model.init_params(0)
    train_loop.make_train_step(model, cfg)(p1, adamw.init(p1, cfg.train),
                                           b, 1)
    with process_group("gloo", rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "s"), 1),
                       timeout=60) as mesh:
        x = torch.randn(5, 7).t()
        assert mesh.comm.psum(x).stride() == x.stride()
        p2 = model.init_params(0)
        dp_step.make_dp_train_step(model, cfg, mesh)(
            p2, adamw.init(p2, cfg.train), None, b, 1)
    assert not dist.is_initialized()
    for (k, a), (_, c) in zip(flat(p1).items(), flat(p2).items()):
        assert torch.equal(a, c), k


def test_dist_communicator_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        DistCommunicator()
    with pytest.raises(RuntimeError, match="no process group"):
        DistMesh()


# ---------------------------------------------------------------------------
def test_dp_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.core, repro_torch.core.dist, "
            "repro_torch.optim.compression, repro_torch.runtime.dp_step, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding_plan\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
