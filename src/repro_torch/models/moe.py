"""Mixture-of-Experts FFN: top-k token-choice routing, sort-based dispatch.

The counterpart of ``repro.models.moe``. Tokens are sorted by expert id
(a stable sort, as ``jnp.argsort``) and packed into a dense (E * C + 1, d)
buffer, C the per-expert capacity: an assignment past its expert's C goes
to the spare row E * C, which is sliced off, so only that row takes
duplicate writes. The experts run as one grouped FFN of three
``torch.bmm``, and each token sums its K contributions in one fixed order,
ascending position in the sorted dispatch (ascending expert id here), which
is the order the reference's sorted scatter-add applies them. No float
atomics: two runs of the same inputs give the same bits.

``moe_forward_sharded`` is the reference's expert-parallel path (the
paper's INTERLEAVE policy applied to experts) written for one shard: the
shard owns E/n experts and routes its resident tokens with a dense
all-to-all over the communicator, a ``core.vmesh`` shard's or, on the
sharded step's DTensors, a ``core.dist.MeshCommunicator`` over the expert
axes of the ``DeviceMesh`` (``moe_forward_dtensor``, the body run on each
rank's local blocks through ``local_map``, as the reference's
``shard_map``). On DTensors ``moe_forward`` (the one-device dispatch, as
decode runs it) keeps the expert weights where they lie: every rank
routes the whole (replicated) tokens, runs its own experts' rows of the
(E, C, d) buffer and gathers the results of the expert group.

Aux losses follow the standard load-balancing formulation
(mean_prob_per_expert x token_fraction_per_expert x E).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, MoEConfig
from repro_torch.core.params import pdef
from repro_torch.kernels.common import is_sharded
from repro_torch.models.layers import activation


def moe_schema(arch: ArchConfig, expert_axis: str = "expert"
               ) -> Dict[str, Any]:
    m = arch.moe
    d, de = arch.d_model, m.d_expert
    E = m.n_experts
    s = {
        "router": pdef((d, E), ("embed", None), "scaled"),
        "w_gate": pdef((E, d, de), (expert_axis, "embed", "expert_ff"),
                       "scaled"),
        "w_up": pdef((E, d, de), (expert_axis, "embed", "expert_ff"),
                     "scaled"),
        "w_down": pdef((E, de, d), (expert_axis, "expert_ff", "embed"),
                       "scaled"),
    }
    if m.n_shared_experts:
        dsh = de * m.n_shared_experts
        s["shared_gate"] = pdef((d, dsh), ("embed", "ff"), "scaled")
        s["shared_up"] = pdef((d, dsh), ("embed", "ff"), "scaled")
        s["shared_down"] = pdef((dsh, d), ("ff", "embed"), "scaled")
    return s


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    per_expert = n_tokens * moe.top_k / moe.n_experts
    cap = int(per_expert * moe.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def shared_expert_forward(p: Dict[str, Any], x: torch.Tensor,
                          arch: ArchConfig) -> torch.Tensor:
    """Always-on (deepseek) shared experts: a plain FFN beside the routed
    dispatch."""
    f = activation(arch.act)
    return (f(x @ p["shared_gate"]) * (x @ p["shared_up"])) @ p["shared_down"]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last axis: the k largest values, ties broken by
    the LOWEST index (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt: torch.Tensor, router: torch.Tensor, K: int):
    """fp32 routing: (probs (T, E), renormalised gates (T, K), ids (T, K))."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, ids = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def _token_fraction(ids: torch.Tensor, E: int, K: int) -> torch.Tensor:
    """Each expert's share of the (token, k) assignments, (E,)."""
    return F.one_hot(ids, E).float().sum(1).mean(0) / K


def group_counts(key: torch.Tensor, n_groups: int) -> torch.Tensor:
    """How many entries of ``key`` (values in [0, n_groups)) fall in each
    group, (n_groups,) int64: ``torch.bincount(key, minlength=n_groups)``
    with a size fixed by ``n_groups`` alone, so that a trace on fake
    tensors (``launch.dryrun``) can follow it."""
    return torch.zeros(n_groups, dtype=torch.int64,
                       device=key.device).scatter_add_(
        0, key.long(), torch.ones(key.shape, dtype=torch.int64,
                                  device=key.device))


def _dispatch_order(key: torch.Tensor, n_groups: int):
    """The stable sort of the flat (token, k) assignments by ``key``:
    (order, sorted keys, each sorted assignment's position in its group,
    group counts)."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    counts = group_counts(key, n_groups)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(key.numel(), device=key.device) - starts[sk]
    return order, sk, pos, counts


def _combine(rows: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             order: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """out[t] = sum over token t's K assignments of rows[slot] * gate, the
    assignments (given in sorted order) added in ascending sorted position
    after 0. ``rows`` ends with a zero row, the slot of a dropped one."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    mine = inv.view(T, K).sort(dim=-1).values         # (T, K) ascending
    parts = rows[slot[mine]] * gate[mine].to(rows.dtype)[..., None]
    out = torch.zeros_like(parts[:, 0])
    for k in range(K):
        out = out + parts[:, k]
    return out


def _expert_ffn(hidden: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, arch: ArchConfig) -> torch.Tensor:
    """The grouped expert FFN over an (E, C, d) buffer: three bmm."""
    f = activation(arch.act)
    return torch.bmm(f(torch.bmm(hidden, wg)) * torch.bmm(hidden, wu), wd)


def moe_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig, *,
                capacity: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). On DTensors the expert weights stay
    in their placement (``_moe_on_expert_blocks``)."""
    if is_sharded(x, p["w_gate"]):
        return _moe_on_expert_blocks(p, x, arch, capacity)
    return _moe_forward(p, x, arch, capacity)


def _moe_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig,
                 capacity: Optional[int], experts=None, shared: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_forward`` on plain tensors; ``experts`` maps the (E, C, d)
    buffer to the experts' outputs (default: every expert here)."""
    m = arch.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = capacity or _capacity(T, m)
    xt = x.reshape(T, d)

    probs, gates, ids = _route(xt, p["router"], K)
    aux = (probs.mean(0) * _token_fraction(ids, E, K)).sum() * E \
        * m.router_aux_weight

    # sort-based dispatch into (E * C + 1, d); the last row takes drops
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    order, se, pos, _ = _dispatch_order(ids.reshape(T * K), E)
    st, sg = flat_t[order], gates.reshape(T * K)[order]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    buf = xt.new_zeros((E * C + 1, d))
    buf[slot] = torch.where(keep[:, None], xt[st], 0)
    hidden = buf[:-1].view(E, C, d)

    # the grouped expert FFN
    if experts is None:
        y_exp = _expert_ffn(hidden, p["w_gate"], p["w_up"], p["w_down"], arch)
    else:
        y_exp = experts(hidden)
    y_exp = y_exp.reshape(E * C, d)
    rows = torch.cat([y_exp, y_exp.new_zeros((1, d))])

    out = _combine(rows, slot, sg * keep, order, T, K)
    if m.n_shared_experts and shared:
        out = out + shared_expert_forward(p, xt, arch)
    return out.reshape(B, S, d), aux


def _expert_axes(w) -> Tuple[str, ...]:
    """The mesh axes that split the DTensor ``w`` along its experts."""
    names = w.device_mesh.mesh_dim_names
    return tuple(a for a, pl in zip(names, w.placements)
                 if pl.is_shard() and pl.dim == 0)


def _moe_on_expert_blocks(p: Dict[str, Any], x: torch.Tensor,
                          arch: ArchConfig, capacity: Optional[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-device dispatch on DTensors, the expert weights where they
    lie (split over the expert axes): every rank routes the tokens,
    gathered whole, into the (E, C, d) buffer, runs the rows of its own
    E/n experts, and the expert group's results are gathered in expert
    order before the combine; the shared experts are added after it, on
    DTensors. Outputs replicated. No gradient flows through the gather:
    a pass that takes one (a train step) takes the expert-parallel
    dispatch (``LMModel``'s ``moe_mesh`` with sequence parallelism)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.dist import MeshCommunicator
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *p.values())):
        raise NotImplementedError(
            "the one-device MoE dispatch on DTensors takes no gradient: "
            "give LMModel moe_mesh and sequence_parallel")
    w = p["w_gate"]
    mesh = w.device_mesh
    comm = MeshCommunicator(mesh, _expert_axes(w))
    el = arch.moe.n_experts // comm.n
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    wpl = tuple(w.placements)

    def body(router, wg, wu, wd, xb):
        def experts(hidden):
            mine = hidden[comm.rank * el:(comm.rank + 1) * el]
            return comm.all_gather(_expert_ffn(mine, wg, wu, wd, arch))
        return _moe_forward({"router": router}, xb, arch, capacity,
                            experts=experts, shared=False)
    out, aux = local_map(body, out_placements=(rep, rep),
                         in_placements=(rep, wpl, wpl, wpl, rep),
                         device_mesh=mesh, redistribute_inputs=True)(
        p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
    if arch.moe.n_shared_experts:
        out = out + shared_expert_forward(p, x, arch)
    return out, aux


def moe_forward_sharded(comm, p: Dict[str, Any], x: torch.Tensor,
                        arch: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on one shard: the reference's
    ``moe_forward_sharded`` body with ``comm`` (a ``core.vmesh`` or
    ``core.dist`` communicator) for its collectives.

    ``x`` (B_loc, S_loc, d) is this shard's resident tokens (the sequence-
    sharded layout: every token lives on one shard); ``p`` holds the
    replicated ``router`` and this shard's contiguous E/n experts of
    ``w_gate``/``w_up``/``w_down`` (what ``P(axis)`` gives on dim 0).
    Each assignment goes to its expert's owner through a dense (n, cap)
    all-to-all, cap = T_loc * K / n * capacity_factor rounded up to 8 (not
    ``_capacity``); an owner's assignments past cap are dropped. The owner
    runs each local expert on the rows that arrived for it (an owner of
    one expert runs it on the whole receive buffer, whose padding rows
    are zero: no shape there depends on the routing, so that a trace on
    fake tensors follows it), and a second all-to-all brings the results
    back. The aux loss is the global one: its two means are averaged over
    the mesh (``comm.pmean``). Shared experts are not applied here (the
    reference adds them outside). Returns (out, aux).
    """
    m = arch.moe
    E, K, n = m.n_experts, m.top_k, comm.n
    if E % n:
        raise ValueError(f"{E} experts not divisible by {n} shards")
    e_local = E // n
    if p["w_gate"].shape[0] != e_local:
        raise ValueError(f"shard holds {p['w_gate'].shape[0]} experts, "
                         f"want {e_local}")
    Bl, Sl, d = x.shape
    T = Bl * Sl
    xt = x.reshape(T, d)
    f = activation(arch.act)

    probs, gates, ids = _route(xt, p["router"], K)
    me = comm.pmean(probs.mean(0))
    ce = comm.pmean(_token_fraction(ids, E, K))
    aux = (me * ce).sum() * E * m.router_aux_weight

    # route each assignment to the shard that owns its expert
    flat_e = ids.reshape(T * K)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    cap = max(8, -(-int(T * K / n * m.capacity_factor) // 8) * 8)
    order, so, pos, counts = _dispatch_order(flat_e // e_local, n)
    se, st, sg = flat_e[order], flat_t[order], gates.reshape(T * K)[order]
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(cap, device=x.device)
    valid = col[None, :] < torch.clamp(counts, max=cap)[:, None]  # (n, cap)
    idx = torch.clamp(starts[:, None] + col[None, :], 0, T * K - 1)
    send_x = torch.where(valid[..., None], xt[st[idx]], 0)
    send_e = torch.where(valid, se[idx] % e_local, -1)
    rx = comm.all_to_all(send_x).reshape(n * cap, d)
    re = comm.all_to_all(send_e).reshape(n * cap)

    # each local expert on the rows that arrived for it
    if e_local == 1:
        y = (f(rx @ p["w_gate"][0]) * (rx @ p["w_up"][0])) @ p["w_down"][0]
    else:
        y = torch.zeros_like(rx)
        for le in range(e_local):
            rows = torch.nonzero(re == le).squeeze(1)
            xin = rx[rows]
            h = f(xin @ p["w_gate"][le]) * (xin @ p["w_up"][le])
            y = y.index_put((rows,), h @ p["w_down"][le])

    # back to the tokens' shards, then each token's K in sorted order
    back = comm.all_to_all(y.view(n, cap, d)).reshape(n * cap, d)
    keep = pos < cap
    slot = torch.where(keep, so * cap + pos, n * cap)
    rows = torch.cat([back, back.new_zeros((1, d))])
    out = _combine(rows, slot, sg * keep, order, T, K)
    return out.reshape(Bl, Sl, d), aux


def moe_forward_dtensor(p: Dict[str, Any], x: torch.Tensor,
                        arch: ArchConfig, expert_axes: Tuple[str, ...]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_forward_sharded`` on the sharded step's DTensors: the body on
    each rank's local blocks (``local_map``, the reference's ``shard_map``
    with in_specs (P(), P(axes) x 3, token_spec) and out_specs
    (token_spec, P())), over a ``core.dist.MeshCommunicator`` of
    ``expert_axes``. ``x`` (B, S, d) must split its tokens over every
    expert axis of more than one rank (the sequence-parallel layout), so
    that each token lives on one rank of the expert group; ``router`` is
    replicated, ``w_gate``/``w_up``/``w_down`` split along their experts
    over the expert axes (redistributed there if they lie otherwise).
    Returns (out in x's placements, aux replicated). A weight's gradient
    is a partial sum over each axis that splits the tokens but not the
    weight."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.dist import MeshCommunicator
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    comm = MeshCommunicator(mesh, expert_axes)
    xpl = tuple(x.placements)
    whole = [a for a in comm.axes if not xpl[names.index(a)].is_shard()]
    if whole:
        raise ValueError(f"the tokens are not split over expert axes "
                         f"{whole}: each must live on one rank")
    rep = tuple(Replicate() for _ in names)
    wpl = tuple(Shard(0) if a in comm.axes else Replicate() for a in names)

    def grads(pl):
        return tuple(q if q.is_shard() else
                     (Partial() if t.is_shard() else Replicate())
                     for q, t in zip(pl, xpl))

    def body(router, wg, wu, wd, xb):
        return moe_forward_sharded(comm, {"router": router, "w_gate": wg,
                                          "w_up": wu, "w_down": wd}, xb, arch)
    return local_map(body, out_placements=(xpl, rep),
                     in_placements=(rep, wpl, wpl, wpl, xpl),
                     in_grad_placements=(grads(rep), grads(wpl), grads(wpl),
                                         grads(wpl), xpl),
                     device_mesh=mesh, redistribute_inputs=True)(
        p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
