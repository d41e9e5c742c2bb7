"""Distributed analytics operators under the paper's placement policies:
the port of ``repro.analytics.engine``.

The same logical query (W1/W2/W3, and every TPC-H plan) executes under
each memory placement policy (paper Section 3.3); the policies change only
the placement and communication plan, never the query code:

  FIRST_TOUCH  every shard aggregates into its own full-width table; the
               merge is an all-reduce over the table.
  LOCAL_ALLOC  the same local tables, merged by a reduce-scatter, so each
               shard owns G/n of the result; an all-gather republishes.
  INTERLEAVE   the table is bucket-interleaved across shards; records are
               routed to their owning shard (all-to-all of the data) and
               aggregated once.
  PREFERRED    all records converge on every shard (all-gather).

Holistic aggregates (median, quantiles, distinct counts) cannot merge from
partials: FIRST_TOUCH / LOCAL_ALLOC / PREFERRED gather every record,
INTERLEAVE routes each group's records to one owner and selects there.

Everything below "record routing" runs INSIDE a virtual mesh
(``repro_torch.core.vmesh``): each shard holds a row slice of the tables,
and where the reference names the mesh axis and calls ``jax.lax``, these
functions take the shard's ``Communicator`` and call its collective of
the same meaning. The planner's distributed executor (planner.py) lowers
every plan onto these primitives; ``dist_count`` / ``dist_median`` /
``dist_hash_join`` are W2 / W1 / W3 as logical plans through it.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.analytics.columnar import (concat_slices, segment_distinct,
                                            segment_median, segment_quantile,
                                            segment_sum, stacked_group_sums)
from repro_torch.analytics.hashing import partition_of
from repro_torch.analytics.physical import ceil128
from repro_torch.core.config import PlacementPolicy, resolve_device
from repro_torch.core.vmesh import Communicator, VirtualMesh
from repro_torch.kernels.radix_partition import block_histograms

I32 = torch.int32
Device = Union[None, str, torch.device]


def _fill(a: torch.Tensor) -> int:
    """Padding of a routed column: -1 for integer columns (the key
    sentinel: it never matches a real join key), 0 otherwise."""
    return 0 if a.is_floating_point() or a.dtype == torch.bool else -1


def _zero_i32(dev) -> torch.Tensor:
    return torch.zeros((), dtype=I32, device=dev)


# ---------------------------------------------------------------------------
# record routing (the all-to-all building block of INTERLEAVE)
# ---------------------------------------------------------------------------
def route_records(keys: torch.Tensor, vals: torch.Tensor, n_shards: int,
                  owner: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket local records by owning shard into a dense (n, capacity) send
    layout. Returns (keys_out, vals_out, overflow int32). Padding key = -1;
    ``vals`` may carry trailing measure dims, (N,) or (N, C)."""
    dev = keys.device
    if keys.shape[0] == 0:  # degenerate empty shard: all-padding send layout
        k_out = torch.full((n_shards, capacity), -1, dtype=keys.dtype,
                           device=dev)
        v_out = torch.zeros((n_shards, capacity) + tuple(vals.shape[1:]),
                            dtype=vals.dtype, device=dev)
        return k_out, v_out, _zero_i32(dev)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_shards)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(capacity, device=dev)
    idx = torch.clamp(starts[:, None] + slot[None, :], 0, keys.shape[0] - 1)
    valid = slot[None, :] < torch.clamp(counts, max=capacity)[:, None]
    rows = order[idx]
    k_out = torch.where(valid, keys[rows], -1)
    vmask = valid.reshape(valid.shape + (1,) * (vals.dim() - 1))
    v_out = torch.where(vmask, vals[rows], 0)
    overflow = torch.clamp(counts - capacity, min=0).sum().to(I32)
    return k_out, v_out, overflow


def route_owner(keys: torch.Tensor, alive: torch.Tensor, n: int,
                method: str = "modulo") -> torch.Tensor:
    """Owner shard (int32) for routing one row set: alive rows co-locate by
    key; dead rows (scan padding, masked rows, an upstream routed buffer's
    padding) spread round-robin, so they never mass on one destination and
    eat its capacity. "modulo" is key % n (dense id domains, and what the
    interleaved republish slot math requires; % floors as in jnp); "hash"
    takes the top radix bits of the multiplicative hash (clustered or
    strided key spaces)."""
    spread = torch.arange(keys.shape[0], dtype=I32, device=keys.device) % n
    if method == "hash":
        owned = partition_of(keys, n)
    elif method == "modulo":
        owned = (keys % n).to(I32)
    else:
        raise ValueError(f"unknown routing method {method!r}")
    return torch.where(alive, owned, spread)


def routing_capacity(n_rows: int, n_shards: int,
                     capacity_factor: float) -> int:
    """Per-destination slot budget for routing ``n_rows`` local records to
    ``n_shards`` owners: the balanced share times ``capacity_factor``,
    rounded up to a 128-row tile."""
    return ceil128(int(capacity_factor * n_rows / n_shards))


def route_table_rows(cols: Dict[str, torch.Tensor], weights: torch.Tensor,
                     owner: torch.Tensor, n_shards: int, capacity: int,
                     comm: Communicator):
    """All-to-all route a struct-of-arrays row set to its owner shards.

    One stable argsort-by-owner layout shared by every column, then one
    all-to-all per column. Integer columns pad with -1, floats with 0;
    ``weights`` rides along so routed padding carries zero weight. Returns
    (cols, weights, overflow): the received buffers hold n_shards *
    capacity rows; rows beyond a destination's capacity are counted in the
    (local, int32) overflow, which the caller psums."""
    n_rows = weights.shape[0]
    if n_rows == 0:
        return _empty_routed(cols, weights, n_shards, capacity)
    dev = weights.device
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_shards)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(capacity, device=dev)
    rows = order[torch.clamp(starts[:, None] + slot[None, :], 0, n_rows - 1)]
    valid = slot[None, :] < torch.clamp(counts, max=capacity)[:, None]

    def exchange(a, fill):
        sent = torch.where(valid, a[rows], fill)
        return comm.all_to_all(sent).reshape(-1)

    out = {c: exchange(a, _fill(a)) for c, a in cols.items()}
    w = exchange(weights, 0)
    overflow = torch.clamp(counts - capacity, min=0).sum().to(I32)
    return out, w, overflow


def _empty_routed(cols: Dict[str, torch.Tensor], weights: torch.Tensor,
                  n_shards: int, capacity: int):
    """Receive-side buffers for the degenerate empty shard (n_rows == 0).

    Every shard is empty when one is (the row count is the same static
    per-shard shape), so each peer would only send padding: the exchange
    is elided and the fully padded buffers are built locally."""
    size = n_shards * capacity
    dev = weights.device
    out = {c: torch.full((size,), _fill(a), dtype=a.dtype, device=dev)
           for c, a in cols.items()}
    w = torch.zeros((size,), dtype=weights.dtype, device=dev)
    return out, w, _zero_i32(dev)


def radix_route_table_rows(cols: Dict[str, torch.Tensor],
                           weights: torch.Tensor, owner: torch.Tensor,
                           n_shards: int, capacity: int, comm: Communicator,
                           *, block: int = 256, mode: Optional[str] = None):
    """All-to-all route a row set via the radix-partition histogram kernel.

    Same contract and BIT-IDENTICAL send layout as ``route_table_rows``,
    built without the argsort: per-block owner histograms come from
    ``block_histograms`` (the CUDA kernel on a CUDA tensor), an exclusive
    prefix over blocks gives each block's base slot per destination, and a
    within-block running count gives each row's stable rank among its
    owner's rows. Rows then scatter into the (n_shards, capacity) send
    buffer at ``owner * capacity + rank``; rows ranked past ``capacity``
    go to one drop slot past the buffer's end (the reference's
    ``mode="drop"``) and are counted in the overflow.

    ``owner`` is padded with zeros to a ``block`` multiple (at the END, so
    real rows' ranks are unaffected) and the destination-0 count is
    corrected. ``n_bins`` is [0, n_shards) rounded up to a power of two.
    Every count and prefix stays int32, as in jnp: PyTorch would promote
    the (blocks, block, n_bins) running count to int64 and double it."""
    n_rows = weights.shape[0]
    if n_rows == 0:
        return _empty_routed(cols, weights, n_shards, capacity)
    dev = weights.device
    n_bins = 1 << max(1, (n_shards - 1).bit_length())
    pad = -n_rows % block
    owner = owner.to(I32)
    owner_p = (torch.cat([owner, owner.new_zeros((pad,))]) if pad
               else owner.contiguous())
    hist = block_histograms(owner_p, n_bins=n_bins, shift=0, block=block,
                            mode=mode)                  # (n_blocks, n_bins)
    counts_all = hist.sum(dim=0, dtype=I32)
    if pad:
        counts_all[0] -= pad
    counts = counts_all[:n_shards]
    # stable rank of each row among its destination's rows, without a sort:
    # exclusive block prefix (base slot of each block per bin) + exclusive
    # within-block running count of the row's own bin
    block_base = torch.cumsum(hist, dim=0, dtype=I32) - hist
    ob = owner_p.reshape(-1, block).to(torch.int64)     # (n_blocks, block)
    oh = (ob[:, :, None] == torch.arange(n_bins, device=dev)).to(I32)
    within = torch.cumsum(oh, dim=1, dtype=I32) - 1     # (blocks, block, bins)
    del oh
    rank_in_block = torch.gather(within, 2, ob[:, :, None])[..., 0]
    del within
    base = torch.gather(block_base, 1, ob)
    rank = (base + rank_in_block).reshape(-1)[:n_rows]
    size = n_shards * capacity
    pos = torch.where(rank < capacity, owner.to(torch.int64) * capacity
                      + rank, size)                      # past the end: drop

    def exchange(a, fill):
        sent = torch.full((size + 1,), fill, dtype=a.dtype, device=dev)
        sent[pos] = a
        return comm.all_to_all(sent[:size].reshape(n_shards, capacity)
                               ).reshape(-1)

    out = {c: exchange(a, _fill(a)) for c, a in cols.items()}
    w = exchange(weights, 0)
    overflow = torch.clamp(counts - capacity, min=0).sum(dtype=I32)
    return out, w, overflow


def compact_routed_rows(cols: Dict[str, torch.Tensor], weights: torch.Tensor,
                        capacity: int):
    """Occupancy-aware re-compaction of a routed buffer (the physical
    planner's ``Compact``): stable-partition the alive rows (weight > 0) to
    the front, original order kept, and cut the buffer to ``capacity``
    rows. Alive rows beyond capacity are counted in the returned int32
    overflow, never dropped silently. Returns (cols, weights, overflow)."""
    alive = weights > 0
    order = torch.argsort(torch.where(alive, 0, 1).to(I32), stable=True)
    idx = order[:capacity]
    kept = {c: a[idx] for c, a in cols.items()}
    w = weights[idx]
    overflow = torch.clamp(alive.sum() - capacity, min=0).to(I32)
    return kept, w, overflow


def pushdown_group_sums(partial: torch.Tensor, n_groups: int,
                        comm: Communicator, n: int, *,
                        capacity_factor: float = 2.0,
                        capacity: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate push-down merge: exchange per-shard PARTIAL sums instead
    of records. Group row g of the local (n_groups, C) table routes to its
    modulo owner g % n, the owner adds its received contributions, and the
    merged rows republish in natural group order. Returns ((n_groups, C)
    replicated, overflow)."""
    G = n_groups
    dev = partial.device
    g = torch.arange(G, dtype=I32, device=dev)
    owner = g % n
    cap = (capacity if capacity is not None
           else routing_capacity(G, n, capacity_factor))
    k_out, v_out, route_ovf = route_records(g, partial, n, owner, cap)
    k_in = comm.all_to_all(k_out)
    v_in = comm.all_to_all(v_out)
    n_slots = (G + (-G % n)) // n
    slot = torch.where(k_in >= 0, k_in // n, n_slots)   # drop slot
    local = segment_sum(v_in.reshape((-1,) + tuple(v_in.shape[2:])),
                        slot.reshape(-1), n_slots + 1)
    gathered = comm.all_gather(local[:n_slots])
    full = gathered[((g % n) * n_slots + g // n).to(torch.int64)]
    return full, comm.psum(route_ovf)


# ---------------------------------------------------------------------------
# per-policy backends of the logical-plan Aggregate (planner.py)
# ---------------------------------------------------------------------------
def merge_partial_table(table: torch.Tensor, policy: PlacementPolicy,
                        comm: Communicator, n: int) -> torch.Tensor:
    """Merge per-shard partial (G, C) group tables into the full table:
    FIRST_TOUCH all-reduces, LOCAL_ALLOC reduce-scatters and all-gathers
    (G padded to a multiple of n for the tiled collectives)."""
    if policy == PlacementPolicy.FIRST_TOUCH:
        return comm.psum(table)
    if policy == PlacementPolicy.LOCAL_ALLOC:
        G = table.shape[0]
        pad = -G % n
        padded = torch.cat([table, table.new_zeros((pad,)
                                                   + tuple(table.shape[1:]))])
        shard = comm.psum_scatter(padded)
        return comm.all_gather(shard)[:G]
    raise ValueError(f"merge_partial_table does not implement {policy}")


def interleave_group_sums(keys: torch.Tensor, vals: torch.Tensor,
                          n_groups: int, comm: Communicator, n: int,
                          aggregate_fn, *, capacity_factor: float = 2.0,
                          capacity: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """INTERLEAVE backend: route records to bucket-interleaved owners
    (all-to-all of the data), aggregate once on the owner with
    ``aggregate_fn(slot_ids, vals, n_slots) -> (sums, overflow)``, then
    republish. The routed buffer parks its padding on one drop slot, so
    ``aggregate_fn`` must use a layout that does not depend on row
    occupancy (the planner's ``_occupancy_safe``). ``capacity`` is the
    Exchange node's slot budget. Returns ((n_groups, C) replicated,
    overflow)."""
    G_pad = n_groups + (-n_groups % n)
    if vals.dim() > 1:
        # column 0 of a stacked matrix carries the selection weights
        owner = route_owner(keys, vals[:, 0] > 0, n)
    else:
        owner = (keys % n).to(I32)
    cap = (capacity if capacity is not None
           else routing_capacity(keys.shape[0], n, capacity_factor))
    k_out, v_out, route_ovf = route_records(keys, vals, n, owner, cap)
    k_in = comm.all_to_all(k_out)
    v_in = comm.all_to_all(v_out)
    # owned group g lives in local slot g // n (g % n == my rank)
    n_slots = G_pad // n
    slot = torch.where(k_in >= 0, k_in // n, n_slots)   # drop slot
    local, agg_ovf = aggregate_fn(slot.reshape(-1),
                                  v_in.reshape((-1,) + tuple(v_in.shape[2:])),
                                  n_slots + 1)
    gathered = comm.all_gather(local[:n_slots])
    g = torch.arange(n_groups, device=keys.device)
    full = gathered[(g % n) * n_slots + g // n]
    return full, comm.psum(route_ovf + agg_ovf)


def gather_rows(arrs, comm: Communicator):
    """PREFERRED building block: converge every shard's rows (all-gather
    of the data) for a tensor, or a tuple or dict of tensors."""
    if isinstance(arrs, torch.Tensor):
        return comm.all_gather(arrs)
    if isinstance(arrs, dict):
        return {k: comm.all_gather(a) for k, a in arrs.items()}
    return type(arrs)(comm.all_gather(a) for a in arrs)


# ---------------------------------------------------------------------------
# holistic (order-statistic) backends
# ---------------------------------------------------------------------------
def _select(k, v, n_groups, rank):
    """One sort-based selection: the median when ``rank`` is None, the
    exact distinct count when it is "distinct", the interpolated ``rank``
    quantile otherwise (all exclude keys < 0)."""
    if rank is None:
        return segment_median(k, v, n_groups)
    if rank == "distinct":
        return segment_distinct(k, v, n_groups)
    return segment_quantile(k, v, n_groups, rank)


def replicated_group_median(keys: torch.Tensor, cols, w: torch.Tensor,
                            n_groups: int, comm: Communicator, ranks=None):
    """FIRST_TOUCH / LOCAL_ALLOC / PREFERRED holistic lowering: gather
    every shard's records and select locally, per value column; the keys
    and weights are gathered once. ``ranks`` maps a column to its
    selector (absent or None = the median). Returns ({name: (n_groups,)
    stats}, counts), replicated."""
    ranks = ranks or {}
    ak = comm.all_gather(keys)
    aw = comm.all_gather(w)
    k_eff = torch.where(aw > 0, ak, -1)
    meds, counts = {}, None
    for name, v in cols.items():
        av = comm.all_gather(v)
        meds[name], counts = _select(k_eff, av, n_groups, ranks.get(name))
    return meds, counts


def interleave_group_median(keys: torch.Tensor, cols, w: torch.Tensor,
                            n_groups: int, comm: Communicator, n: int, *,
                            capacity_factor: float = 2.0, ranks=None):
    """INTERLEAVE holistic lowering: route each group's records to its
    bucket-interleaved owner, select there, republish in natural group
    order. Every value column rides ONE routing pass. Returns ({name:
    (n_groups,) stats}, counts, overflow), replicated."""
    ranks = ranks or {}
    k_eff = torch.where(w > 0, keys, -1).to(I32)
    owner = route_owner(k_eff, k_eff >= 0, n)
    cap = routing_capacity(keys.shape[0], n, capacity_factor)
    # positional names: aggregate output names could collide with "k"
    send = {"k": k_eff}
    send.update({f"v{i}": v for i, v in enumerate(cols.values())})
    routed, w_in, ovf = route_table_rows(send, w, owner, n, cap, comm)
    n_slots = -(-n_groups // n)
    local_ids = torch.where((routed["k"] >= 0) & (w_in > 0),
                            routed["k"] // n, -1)
    g = torch.arange(n_groups, device=keys.device)  # owner of g is g % n
    pos = (g % n) * n_slots + g // n
    meds, counts = {}, None
    for i, name in enumerate(cols):
        med, cnt = _select(local_ids, routed[f"v{i}"], n_slots,
                           ranks.get(name))
        meds[name] = comm.all_gather(med)[pos]
        counts = comm.all_gather(cnt)[pos]
    return meds, counts, comm.psum(ovf)


def placed_group_median(keys: torch.Tensor, cols, w: torch.Tensor,
                        n_groups: int, comm: Communicator, ranks=None):
    """Route-once holistic lowering: the child is already placed by the
    group key, so exactly one shard holds all of a group's alive rows; each
    statistic is selected locally and merged by a psum of owner-only
    values (non-owners see an empty group and are masked out). Returns
    ({name: (n_groups,) stats}, counts), replicated."""
    ranks = ranks or {}
    k_eff = torch.where(w > 0, keys, -1).to(I32)
    meds, counts = {}, None
    for name, v in cols.items():
        sel = ranks.get(name)
        stat, cnt = _select(k_eff, v, n_groups, sel)
        cnt_all = comm.psum(cnt)
        if sel == "distinct":
            # a distinct count is 0 (not NaN) on non-owner shards: the
            # psum alone reconstructs the owner's exact count
            meds[name] = comm.psum(stat)
        else:
            stat_all = comm.psum(torch.where(cnt > 0, stat, 0.0))
            meds[name] = torch.where(cnt_all > 0, stat_all, torch.nan)
        counts = cnt_all
    return meds, counts


def _rebalance_to_interleave(table: torch.Tensor, n: int,
                             comm: Communicator) -> torch.Tensor:
    """AutoNUMA analogue: migrate a REPLICATED table toward interleaved
    ownership, pure extra collective traffic on an already-merged result.
    The reduce-scatter sums n identical copies, so the division comes
    AFTER it ((n*x)/n is exact for integer counts; x/n summed n times is
    not). The leading dim is padded to a multiple of n."""
    G = table.shape[0]
    pad = -G % n
    padded = torch.cat([table, table.new_zeros((pad,)
                                               + tuple(table.shape[1:]))])
    shard = comm.psum_scatter(padded) / n
    return comm.all_gather(shard)[:G]


# ---------------------------------------------------------------------------
# morsel-sliced distributive aggregation (the serving scheduler's unit)
# ---------------------------------------------------------------------------
# A morsel is a contiguous row range of a scan. The serving scheduler
# (analytics/service/scheduler.py) runs morsels on its worker pools and
# merges the per-morsel partials in MORSEL ORDER, so the merged result is
# the same for a fixed morsel size whichever pool ran which morsel.

def morsel_slices(n_rows: int, morsel_rows: Optional[int]
                  ) -> List[Tuple[int, int]]:
    """[lo, hi) row ranges covering n_rows; the last morsel takes the
    remainder when n_rows is not divisible by morsel_rows. None = one
    morsel (whole scan)."""
    if morsel_rows is not None and morsel_rows < 1:
        raise ValueError("morsel_rows must be >= 1")
    if morsel_rows is None or morsel_rows >= n_rows:
        return [(0, n_rows)]
    return [(lo, min(lo + morsel_rows, n_rows))
            for lo in range(0, n_rows, morsel_rows)]


def morsel_slice_columns(cols: Dict[str, torch.Tensor], lo: int,
                         length: int) -> Dict[str, torch.Tensor]:
    """Every column of a scan narrowed to one morsel's rows [lo, lo+length)
    (views, no copy)."""
    return {c: a.narrow(0, int(lo), length) for c, a in cols.items()}


def morsel_group_sums(keys: torch.Tensor, vals: torch.Tensor, n_groups: int,
                      *, layout: str = "xla", mode: Optional[str] = None,
                      n_partitions: int = 64, capacity_factor: float = 2.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial (n_groups, C) sums over ONE morsel's (already-sliced) rows,
    under the same layouts the planner chooses between; the (sums, int32
    overflow) pair is what ``merge_morsel_partials`` folds."""
    return stacked_group_sums(
        keys, vals, n_groups, layout=layout, mode=mode,
        n_partitions=n_partitions, capacity_factor=capacity_factor)


def merge_morsel_partials(partials: Sequence[Tuple[Any, torch.Tensor]]
                          ) -> Tuple[Any, torch.Tensor]:
    """Merge per-morsel partials in morsel order.

    Distributive aggregates give (sums, overflow) pairs, left-folded by
    addition: the fold order is part of the result's float semantics, so
    merging in sequence order (not completion order) keeps served answers
    the same under work stealing. Split-probe pipelines give
    ((columns, mask), overflow): each morsel's slice of the pre-aggregate
    table, concatenated in sequence order (``concat_slices``), which
    rebuilds the serial table bit for bit."""
    if not partials:
        raise ValueError("no morsel partials to merge")
    head = partials[0][0]
    if isinstance(head, tuple) and len(head) == 2 and isinstance(
            head[0], dict):
        merged = concat_slices([p[0] for p in partials])
        overflow = partials[0][1]
        for _, o in partials[1:]:
            overflow = overflow + o
        return merged, overflow
    sums, overflow = partials[0]
    for s, o in partials[1:]:
        sums = sums + s
        overflow = overflow + o
    return sums, overflow


# ---------------------------------------------------------------------------
# W1 / W2 / W3 under each policy, as logical plans through the planner
# ---------------------------------------------------------------------------
def dist_count(n_shards: int, policy: PlacementPolicy, cardinality: int, *,
               capacity_factor: float = 2.0, auto_rebalance: bool = False,
               device: Device = None) -> Callable:
    """W2: fn(keys (N,)) -> (G,) counts, in natural group order under every
    policy, run on a virtual mesh of ``n_shards`` shards on ``device`` (the
    CUDA device unless the caller names another).

    The count is a logical ``Aggregate`` lowered through the planner's
    distributed backend, so it shares every placement strategy with the
    TPC-H plans. ``auto_rebalance`` (the AutoNUMA analogue) appends a
    policy-ideal resharding of the merged table."""
    from repro_torch.analytics import plan as L
    from repro_torch.analytics import planner

    dev = resolve_device(device)
    lplan = L.LogicalPlan(
        L.scan("keys").aggregate("k", cardinality, count=("count", "k")),
        ("count",))
    ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                   policy=policy,
                                   capacity_factor=capacity_factor)
    mesh = VirtualMesh(n_shards, dev)

    def fn(keys):
        counts = planner.execute_plan(
            lplan, {"keys": {"k": torch.as_tensor(keys, device=dev)}},
            ctx)["count"]
        if auto_rebalance:  # AutoNUMA: reshard toward interleave post hoc
            counts = mesh.run(
                lambda comm, t: _rebalance_to_interleave(t, n_shards, comm),
                [counts] * n_shards)[0]
        return counts

    return fn


def dist_median(n_shards: int, policy: PlacementPolicy, cardinality: int, *,
                capacity_factor: float = 2.0,
                device: Device = None) -> Callable:
    """W1: fn(keys, vals) -> (G,) per-group medians, in natural group order
    under every policy: FIRST_TOUCH / LOCAL_ALLOC / PREFERRED replicate the
    records, INTERLEAVE runs the routed distributed selection."""
    from repro_torch.analytics import plan as L
    from repro_torch.analytics import planner

    dev = resolve_device(device)
    lplan = L.LogicalPlan(
        L.scan("t").aggregate("k", cardinality, med=("median", "v")),
        ("med",))
    ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                   policy=policy,
                                   capacity_factor=capacity_factor)

    def fn(keys, vals):
        return planner.execute_plan(
            lplan, {"t": {"k": torch.as_tensor(keys, device=dev),
                          "v": torch.as_tensor(vals, device=dev)}},
            ctx)["med"]

    return fn


def dist_hash_join(n_shards: int, policy: PlacementPolicy, *,
                   capacity_factor: float = 2.0,
                   device: Device = None) -> Callable:
    """W3: fn(build_keys, build_vals, probe_keys) -> (count, checksum).

    A logical ``Join`` + global ``Aggregate``; the policy fixes the
    distributed join strategy: INTERLEAVE routes both sides by join key
    (partitioned), the replication policies broadcast the build side.
    ``dist_route="modulo"`` keeps the reference's routing (key % n)."""
    from repro_torch.analytics import plan as L
    from repro_torch.analytics import planner

    dev = resolve_device(device)
    probe = L.scan("probe").join(L.scan("build"), "pk", "bk", {"_v": "bv"})
    lplan = L.LogicalPlan(
        probe.aggregate(None, 1, count=("count", "_v"),
                        checksum=("sum", "_v")),
        ("count", "checksum"))
    dist_join = ("partitioned" if policy == PlacementPolicy.INTERLEAVE
                 else "broadcast")
    ctx = planner.ExecutionContext(executor="xla", n_shards=n_shards,
                                   policy=policy,
                                   capacity_factor=capacity_factor,
                                   dist_join=dist_join, dist_route="modulo")

    def fn(bk, bv, pk):
        out = planner.execute_plan(
            lplan, {"probe": {"pk": torch.as_tensor(pk, device=dev)},
                    "build": {"bk": torch.as_tensor(bk, device=dev),
                              "bv": torch.as_tensor(bv, device=dev)}}, ctx)
        return out["count"][0], out["checksum"][0]

    return fn
