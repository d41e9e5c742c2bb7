"""The port's MoE layer and the phi3.5-moe model against the JAX reference
on the CPU.

Weights come from the reference's ``init_params`` (carried across with
``from_reference``), inputs from numpy seeds. Tolerances are those of
tests/test_torch_lm.py: 1e-5 for one module, 1e-4 for a reduced model's
logits, 2e-3 for decode against forward, and each gradient leaf within
1e-5 of its largest |grad| (tests/test_torch_train.py). Decode against
forward runs the arch with capacity_factor = n_experts / top_k, so that
no assignment is dropped in either (C >= T): at the published 1.25 the
forward drops assignments that decode, with C >= 8 for a handful of
tokens, never drops.

The expert-parallel path runs on a virtual mesh of 4 shards here and
under ``shard_map`` on 4 fake CPU devices in one reference subprocess.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.configs.reduced import REDUCED as REF_REDUCED
from repro.core.params import init_params as ref_init
from repro.models import moe as ref_moe
from repro.models.lm import LMModel as RefLM
from repro_torch.configs.reduced import REDUCED
from repro_torch.core.params import from_reference
from repro_torch.core.vmesh import VirtualMesh
from repro_torch.models import moe
from repro_torch.models.layers import activation
from repro_torch.models.lm import LMModel

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL = 1e-5
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
PHI = "phi3.5-moe"


def carry(tree):
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.array(x))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def with_moe(arch, **kw):
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, **kw))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _layer(arch, seed=0, T=(2, 20), skew=0.0):
    """The reference's seeded layer weights and an input (B, S, d); with
    ``skew`` the tokens share a direction that expert 0's router column
    follows, so expert 0 takes most tokens."""
    p = ref_init(ref_moe.moe_schema(arch), jax.random.PRNGKey(seed),
                 jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(*T, arch.d_model).astype(np.float32)
    if skew:
        u = rng.randn(arch.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x += skew * u
        p = dict(p, router=p["router"].copy())
        p["router"][:, 0] += skew * u
    return p, x


def _dropped(ids, E, C):
    """The (token, k) assignments past their expert's capacity C, under a
    stable sort of the flat assignments by expert."""
    flat = np.asarray(ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    seen, out = {}, set()
    for i in order:
        e = int(flat[i])
        if seen.get(e, 0) >= C:
            out.add(divmod(int(i), ids.shape[1]))
        seen[e] = seen.get(e, 0) + 1
    return out


def _loop_moe(p, x, arch, dropped):
    """The routed experts token by token, in float64: each kept
    assignment's expert FFN on the token, times its renormalised gate."""
    m = arch.moe
    f = activation(arch.act)
    xt = t(x.reshape(-1, x.shape[-1])).double()
    probs = torch.softmax(xt @ t(p["router"]).double(), -1)
    gates, ids = moe.top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    w = {k: t(p[k]).double() for k in ("w_gate", "w_up", "w_down")}
    out = torch.zeros_like(xt)
    for tok in range(xt.shape[0]):
        for k in range(m.top_k):
            if (tok, k) in dropped:
                continue
            e = int(ids[tok, k])
            h = f(xt[tok] @ w["w_gate"][e]) * (xt[tok] @ w["w_up"][e])
            out[tok] += gates[tok, k] * (h @ w["w_down"][e])
    return out.reshape(x.shape).numpy()


def _ref_ids(p, x, arch):
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, arch.moe.top_k)[1])


@pytest.mark.parametrize("case", ["reduced factor 4.0",
                                  "factor 1.25, expert 0 overflows",
                                  "top_k 3", "shared experts"])
def test_moe_forward_matches_reference(case):
    name = "deepseek-v3" if case == "shared experts" else PHI
    arch, ref_arch = REDUCED[name], REF_REDUCED[name]
    skew = 0.0
    if case.startswith("factor 1.25"):
        arch, ref_arch = (with_moe(a, capacity_factor=1.25)
                          for a in (arch, ref_arch))
        skew = 6.0
    elif case == "top_k 3":
        arch, ref_arch = (with_moe(a, top_k=3) for a in (arch, ref_arch))
    assert bool(arch.moe.n_shared_experts) == (case == "shared experts")
    p, x = _layer(ref_arch, skew=skew)
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_forward(
        p, x, ref_arch))(p, jnp.asarray(x))
    got, aux = moe.moe_forward(carry(p), t(x), arch)
    close(got, want, MODULE_TOL)
    close(aux, want_aux, dict(rtol=1e-5, atol=1e-9))

    T = x.shape[0] * x.shape[1]
    C = moe._capacity(T, arch.moe)
    ids = moe._route(t(x).reshape(T, -1), t(p["router"]),
                     arch.moe.top_k)[2]
    np.testing.assert_array_equal(ids.numpy(), _ref_ids(p, x, ref_arch))
    dropped = _dropped(ids.numpy(), arch.moe.n_experts, C)
    assert dropped == _dropped(_ref_ids(p, x, ref_arch),
                               arch.moe.n_experts, C)
    assert bool(dropped) == case.startswith("factor 1.25"), len(dropped)
    if not arch.moe.n_shared_experts:
        # the kept assignments and nothing else, token by token
        close(got, _loop_moe(p, x, arch, dropped), MODULE_TOL)
    # no float atomics: the same bits on every run
    again, _ = moe.moe_forward(carry(p), t(x), arch)
    assert torch.equal(got, again)


def test_moe_combine_adds_in_ascending_expert_order():
    """Each token's K contributions are added after 0 in ascending expert
    id, whatever their top-k order. With K=3 and contributions of very
    different sizes the order shows in the bits."""
    T, K, E, d = 64, 3, 8, 16
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(np.stack([rng.choice(E, K, replace=False)
                                     for _ in range(T)]))
    order, se, pos, _ = moe._dispatch_order(ids.reshape(-1), E)
    slot = se * T + pos                          # C = T: nothing drops
    rows = rng.randn(E * T + 1, d) * 10.0 ** rng.uniform(-6, 6,
                                                         (E * T + 1, 1))
    rows[-1] = 0
    rows = torch.from_numpy(rows.astype(np.float32))
    gate = torch.from_numpy(rng.rand(T * K).astype(np.float32))
    got = moe._combine(rows, slot, gate, order, T, K)
    tok = torch.arange(T).repeat_interleave(K)[order]
    parts = {}
    for i in range(T * K):
        parts.setdefault(int(tok[i]), []).append(
            (int(se[i]), rows[slot[i]] * gate[i]))
    ascending = torch.stack([sum((c for _, c in sorted(parts[j])),
                                 torch.zeros(d)) for j in range(T)])
    descending = torch.stack([sum((c for _, c in sorted(parts[j])[::-1]),
                                  torch.zeros(d)) for j in range(T)])
    assert torch.equal(got, ascending)
    assert not torch.equal(got, descending)


# ---------------------------------------------------------------------------
# expert parallelism on a virtual mesh
# ---------------------------------------------------------------------------
N_SHARDS = 4
EP_CASES = {"factor 4.0": (4.0, 0.0), "factor 1.25, skewed": (1.25, 6.0)}

REF_SHARDED = r'''
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.reduced import REDUCED
from repro.models import moe

data = dict(np.load(IN_PATH))
mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
out = {}
for tag, cf in CASES:
    arch = REDUCED["phi3.5-moe"]
    arch = dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, n_experts=8, capacity_factor=cf))
    p = {k: jnp.asarray(data[tag + k])
         for k in ("router", "w_gate", "w_up", "w_down")}
    fn = jax.jit(lambda p, x: moe.moe_forward_sharded(
        p, x, arch, mesh=mesh, expert_axes=("model",),
        token_spec=P(None, "model", None)))
    y, aux = fn(p, jnp.asarray(data[tag + "x"]))
    out[tag + "y"], out[tag + "aux"] = np.asarray(y), np.asarray(aux)
np.savez(OUT_PATH, **out)
'''


def _ep_arch(arch, cf):
    return with_moe(arch, n_experts=8, capacity_factor=cf)


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    """(inputs, the reference's outputs) of both cases: 8 experts (2 a
    shard), x (2, 32, d) sequence-sharded 4 ways."""
    d = tmp_path_factory.mktemp("moe_ep")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    arrays = {}
    for i, (tag, (cf, skew)) in enumerate(EP_CASES.items()):
        p, x = _layer(_ep_arch(REF_REDUCED[PHI], cf), seed=10 + i,
                      T=(2, 32), skew=skew)
        arrays.update({tag + k: v for k, v in p.items()}, **{tag + "x": x})
    np.savez(inp, **arrays)
    cases = [(tag, cf) for tag, (cf, _) in EP_CASES.items()]
    run_with_devices(REF_SHARDED.replace("IN_PATH", repr(inp))
                     .replace("OUT_PATH", repr(outp))
                     .replace("CASES", repr(cases)),
                     n_devices=N_SHARDS, timeout=300)
    return arrays, dict(np.load(outp))


@pytest.mark.parametrize("tag", list(EP_CASES))
def test_moe_forward_sharded_matches_reference(ep_reference, tag):
    arrays, want = ep_reference
    cf, _ = EP_CASES[tag]
    arch = _ep_arch(REDUCED[PHI], cf)
    p = {k: t(arrays[tag + k]) for k in ("router", "w_gate", "w_up",
                                          "w_down")}
    x = t(arrays[tag + "x"])
    el, sl = 8 // N_SHARDS, x.shape[1] // N_SHARDS
    inputs = [({"router": p["router"],
                **{k: p[k][i * el:(i + 1) * el]
                   for k in ("w_gate", "w_up", "w_down")}},
               x[:, i * sl:(i + 1) * sl]) for i in range(N_SHARDS)]
    outs = VirtualMesh(N_SHARDS, "cpu", timeout=60).run(
        lambda comm, a: moe.moe_forward_sharded(comm, a[0], a[1], arch),
        inputs)
    got = torch.cat([y for y, _ in outs], dim=1)
    close(got, want[tag + "y"], MODULE_TOL)
    for _, aux in outs:
        close(aux, want[tag + "aux"], dict(rtol=1e-5, atol=1e-9))
    if cf == 4.0:
        # nothing drops in either path: the same as the one-device layer
        full, full_aux = moe.moe_forward(p, x, arch)
        close(got, full, MODULE_TOL)
        close(outs[0][1], full_aux, dict(rtol=1e-5, atol=1e-9))
    else:
        # the skew overflows shard 0's capacity: drops, as in the reference
        assert not np.allclose(f32(got), f32(moe.moe_forward(
            p, x, with_moe(arch, capacity_factor=8.0))[0]), atol=1e-3)


def test_moe_forward_sharded_checks_its_experts():
    arch = _ep_arch(REDUCED[PHI], 4.0)
    p, x = _layer(_ep_arch(REF_REDUCED[PHI], 4.0), T=(1, 8))
    tp = carry(p)
    with pytest.raises(ValueError, match="want 2"):
        VirtualMesh(N_SHARDS, "cpu", timeout=10).run(
            lambda comm, a: moe.moe_forward_sharded(comm, tp, a, arch),
            [t(x)[:, 2 * i:2 * i + 2] for i in range(N_SHARDS)])
    with pytest.raises(ValueError, match="not divisible"):
        VirtualMesh(3, "cpu", timeout=10).run(
            lambda comm, a: moe.moe_forward_sharded(comm, tp, a, arch),
            [t(x)] * 3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
PHI_VARIANTS = {
    "phi3.5-moe": {},
    "phi3.5-moe, a dense layer and a shared expert": dict(
        n_dense_layers=1, dense_d_ff=48, n_shared_experts=1),
}


def _phi(variant):
    kw = PHI_VARIANTS[variant]
    return ((with_moe(REF_REDUCED[PHI], **kw), with_moe(REDUCED[PHI], **kw))
            if kw else (REF_REDUCED[PHI], REDUCED[PHI]))


def _tokens(arch, seed, B=2, S=12):
    rng = np.random.RandomState(seed)
    return rng.randint(1, arch.vocab_size, (B, S + 1)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("variant", list(PHI_VARIANTS))
def test_phi_forward_loss_and_grads_match_reference(variant):
    ref_arch, arch = _phi(variant)
    ref_model = RefLM(ref_arch, remat="block")
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(arch, device="cpu")
    p = carry(ref_p)
    if PHI_VARIANTS[variant]:
        assert p["dense_blocks"]["mlp"]["w_gate"].shape == (1, 64, 48)
        assert p["blocks"]["moe"]["shared_up"].shape == (3, 64, 32)
    ids = _tokens(arch, 3)
    nb = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want, _, want_aux = jax.jit(ref_model.forward)(ref_p, jb)
    got, _, aux = model.forward(p, {"tokens": t(nb["tokens"])})
    close(got, want, MODEL_TOL)
    close(aux, want_aux, dict(rtol=1e-5, atol=1e-9))
    assert float(aux) > 0
    last, last_aux = model.prefill(p, {"tokens": t(nb["tokens"])})
    close(last, got[:, -1:], MODULE_TOL)
    assert float(last_aux) == float(aux)

    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, b, z_loss=1e-4), has_aux=True))(
        ref_p, jb)
    for v in _flat(p).values():
        v.requires_grad_()
    loss, m = model.loss_fn(p, {k: t(v) for k, v in nb.items()},
                            z_loss=1e-4)
    np.testing.assert_allclose(f32(loss), f32(want_l), rtol=1e-5)
    for k in ("ce", "aux", "z"):
        np.testing.assert_allclose(f32(m[k]), f32(want_m[k]), rtol=1e-5,
                                   atol=1e-9)
    loss.backward()
    ref_g = _flat(jax.tree.map(np.asarray, want_g))
    grads = {k: v.grad for k, v in _flat(p).items()}
    assert grads.keys() == ref_g.keys()
    for k, g in grads.items():
        top = float(np.abs(ref_g[k]).max())
        err = float(np.abs(f32(g) - ref_g[k]).max())
        assert err <= GRAD_REL * top, (k, err, top)


def _close_cache(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("variant", list(PHI_VARIANTS))
def test_phi_decode_matches_reference_and_forward(variant):
    """Decode against the reference's decode at the reduced config, and
    against the port's forward at the no-drop capacity factor."""
    ref_arch, arch = _phi(variant)
    ref_model = RefLM(ref_arch, remat="none", cache_dtype=jnp.float32)
    ref_p = ref_init(ref_model.schema(), KEY, jnp.float32)
    model = LMModel(arch, device="cpu", cache_dtype=torch.float32)
    p = carry(ref_p)
    S = 10
    ids = _tokens(arch, 5, S=S)[:, :S]
    ref_cache = ref_model.init_cache(2, S + 2)
    cache = model.init_cache(2, S + 2)
    assert set(cache) == set(ref_cache)
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(S):
        col = ids[:, step:step + 1]
        want, ref_cache = ref_step(ref_p, ref_cache,
                                   {"tokens": jnp.asarray(col)})
        got, cache = model.decode_step(p, cache, {"tokens": t(col)})
        close(got, want, MODEL_TOL)
    jax.tree.map(_close_cache, cache, carry(ref_cache))

    m = arch.moe
    no_drop = LMModel(with_moe(arch, capacity_factor=m.n_experts / m.top_k),
                      device="cpu", cache_dtype=torch.float32)
    full, _, _ = no_drop.forward(p, {"tokens": t(ids)})
    cache = no_drop.init_cache(2, S + 1)
    for step in range(S):
        got, cache = no_drop.decode_step(p, cache,
                                         {"tokens": t(ids[:, step:step + 1])})
        np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, step]),
                                   atol=2e-3, rtol=2e-3)
