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
paper's INTERLEAVE policy applied to experts) written for one shard of a
``core.vmesh.VirtualMesh``: the shard owns E/n experts and routes its
resident tokens with a dense all-to-all over the communicator.

Aux losses follow the standard load-balancing formulation
(mean_prob_per_expert x token_fraction_per_expert x E).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, MoEConfig
from repro_torch.core.params import pdef
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


def _dispatch_order(key: torch.Tensor, n_groups: int):
    """The stable sort of the flat (token, k) assignments by ``key``:
    (order, sorted keys, each sorted assignment's position in its group,
    group counts)."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    counts = torch.bincount(key, minlength=n_groups)
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


def moe_forward(p: Dict[str, Any], x: torch.Tensor, arch: ArchConfig, *,
                capacity: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
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
    f = activation(arch.act)
    h = f(torch.bmm(hidden, p["w_gate"])) * torch.bmm(hidden, p["w_up"])
    y_exp = torch.bmm(h, p["w_down"]).reshape(E * C, d)
    rows = torch.cat([y_exp, y_exp.new_zeros((1, d))])

    out = _combine(rows, slot, sg * keep, order, T, K)
    if m.n_shared_experts:
        out = out + shared_expert_forward(p, xt, arch)
    return out.reshape(B, S, d), aux


def moe_forward_sharded(comm, p: Dict[str, Any], x: torch.Tensor,
                        arch: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on one shard of a virtual mesh: the reference's
    ``moe_forward_sharded`` body with ``comm`` (a ``core.vmesh``
    communicator) for its collectives.

    ``x`` (B_loc, S_loc, d) is this shard's resident tokens (the sequence-
    sharded layout: every token lives on one shard); ``p`` holds the
    replicated ``router`` and this shard's contiguous E/n experts of
    ``w_gate``/``w_up``/``w_down`` (what ``P(axis)`` gives on dim 0).
    Each assignment goes to its expert's owner through a dense (n, cap)
    all-to-all, cap = T_loc * K / n * capacity_factor rounded up to 8 (not
    ``_capacity``); an owner's assignments past cap are dropped. The owner
    runs each local expert on the rows that arrived for it, and a second
    all-to-all brings the results back. The aux loss is the global one:
    its two means are averaged over the mesh. Shared experts are not
    applied here (the reference adds them outside). Returns (out, aux).
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
    me = comm.psum(probs.mean(0)) / n
    ce = comm.psum(_token_fraction(ids, E, K)) / n
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
