"""Physical columnar operators: the port of ``repro.analytics.columnar``.

A Table is a struct-of-arrays of equal-length tensors; selection is
mask-based (predicates become aggregation weights), joins are PK-FK
gathers through a sorted index, aggregations are masked segment ops. The
planner (planner.py) lowers each logical node onto one operator here.

Grouped aggregation has the reference's three layouts. Every (sum, avg,
count) aggregate over one key is stacked into one values matrix
(``stacked_columns``), which each layout sums:

  "xla"          plain PyTorch segment sums (the name is kept because the
                 explain output prints it): one stable sort by group and a
                 per-segment reduction of each column, the same bits on
                 every run (``segment_sum``).
  "dense"        ONE pass of the hash_aggregate kernel over positional
                 chunks; key domains up to DENSE_GROUP_LIMIT.
  "partitioned"  the same fused pass after a range-partitioning pass, so
                 each partition's table stays narrow; overflow is counted.

Order statistics (max/min/median/quantile/distinct) stay on exact
sort-based or segment lowerings under every layout.

PK-FK joins: ``pkfk_join`` (sorted-index searchsorted gather; the build
argsort is cached on the Table) and ``pkfk_join_kernel`` (hash-partition
both sides and probe through the join_probe kernel; capacity overflow
triggers a residual re-probe through the sorted path, or is counted with
``residual=False``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.analytics import tracing
from repro_torch.analytics.hashing import pad_partitions, partition_of
from repro_torch.analytics.plan import is_holistic, parse_quantile
from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
from repro_torch.kernels.join_probe import join_probe

# Largest key domain aggregated with full-width per-chunk tables; beyond
# it the kernel path range-partitions so each partition table stays narrow.
# The value is the reference's (its TPU's VMEM model); the H100's is
# fitted by scripts/calibrate_costs_torch.py --sweep-groups and carried
# by a loaded profile's dense_group_limit.
DENSE_GROUP_LIMIT = 4096
# Longest segment up to which ``segment_sum`` reduces each segment serially
# on one thread (beyond it, a block's tree per segment and column).
SERIAL_SEGMENT_ROWS = 1024

F32 = torch.float32


@dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    mask: Optional[torch.Tensor] = None     # float32 selection weights
    # name -> (order, sorted_keys) argsort cache for join build sides,
    # shared with derived tables whose column arrays are unchanged.
    index_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        lens = {c.shape[0] for c in self.columns.values()}
        if len(lens) != 1:
            raise ValueError(f"ragged table: {lens}")

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def weights(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones((self.n_rows,), dtype=F32, device=self.device)
        return self.mask

    def key_index(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(order, sorted_keys) for ``name``, built once per column."""
        hit = self.index_cache.get(name)
        if hit is None:
            k = self.columns[name]
            order = torch.argsort(k, stable=True)
            hit = (order, k[order])
            self.index_cache[name] = hit
        return hit

    def filter(self, pred: torch.Tensor) -> "Table":
        """AND a predicate into the selection mask (no data movement)."""
        return Table(self.columns, self.weights() * pred.to(F32),
                     self.index_cache)

    def with_columns(self, **cols: torch.Tensor) -> "Table":
        merged = dict(self.columns)
        merged.update(cols)
        cache = {k: v for k, v in self.index_cache.items() if k not in cols}
        return Table(merged, self.mask, cache)


def concat_slices(parts):
    """Concatenate (columns, mask) row-slice pairs, in order, into one
    (columns, mask) pair.

    The merge primitive of the serving tier's split-probe path: each part
    is one morsel's slice of a per-row pipeline's output, so concatenation
    in slice order rebuilds the unsliced table bit for bit (a row concat,
    never a float re-ordering). Dtypes are kept; ``mask`` is None only
    when every part's mask is None."""
    cols0, mask0 = parts[0]
    cols = {c: torch.cat([p[0][c] for p in parts]) for c in cols0}
    mask = None if mask0 is None else torch.cat([p[1] for p in parts])
    return cols, mask


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 2-D ``x``, bit for bit. PyTorch's CUDA gather
    launches one tiny block per row when a row is a multiple of 16 bytes
    (4 or 8 f32 columns), so such rows gather far slower than a row of 3
    or 6 columns (``chip_smoke.py``'s calibration times the segment sums
    at each width); they are gathered here as the 16-byte elements of a
    flat view instead, which takes the ordinary element-wise path."""
    row = x.shape[1] * x.element_size()
    if (row == 0 or row % 16 or not x.is_contiguous()
            or x.storage_offset() * x.element_size() % 16):
        return x[idx]
    k = row // 16
    if k > 1:
        idx = (idx.unsqueeze(1) * k
               + torch.arange(k, device=idx.device)).reshape(-1)
    flat = x.view(torch.complex128).reshape(-1)     # (N * k,) 16-byte rows
    return flat[idx].view(x.dtype).reshape(-1, x.shape[1])


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: sums rows of ``data`` by ``ids`` into n
    segments, DROPPING ids outside [0, n) (they go to a spare segment that
    is sliced off).

    The same bits on every run, on every device: rows are stably sorted by
    segment and reduced per segment by ``torch.segment_reduce`` (no float
    atomics, which ``index_add_`` uses on a CUDA tensor). Segment offsets
    come from a binary search of the sorted ids, so nothing is counted
    with atomics either. The reduction follows the LONGEST segment (one
    read of a device scalar): when every segment is short, one call over
    all columns sums each segment serially on a thread of its own; when
    one is long (a hot group, or the zero-weight padding rows of a routed
    buffer that clip into group 0), one call per column sums each segment
    with a block's tree. Each is far the faster at its end on a card
    (``chip_smoke.py`` times q1's and q18's shapes). The route is a
    function of the data, so equal inputs give equal bits."""
    # int32 ids halve the sort's radix passes
    itype = torch.int32 if n < (1 << 31) - 2 else torch.int64
    ids = torch.where((ids >= 0) & (ids < n), ids, n).to(itype)
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(n + 2, dtype=itype, device=ids.device))
    width = math.prod(data.shape[1:])
    rows = take_rows(data.reshape(data.shape[0], width), order)
    serial = data.shape[0] <= SERIAL_SEGMENT_ROWS
    if not serial:
        with tracing.span("sync:segment_sum.longest", "sync"):
            serial = int(torch.diff(offsets).max()) <= SERIAL_SEGMENT_ROWS
    if serial:
        out = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                                   unsafe=True)
    else:
        out = torch.stack([torch.segment_reduce(
            rows[:, c].contiguous(), "sum", offsets=offsets, unsafe=True)
            for c in range(width)], dim=1)
    return out[:n].reshape((n,) + tuple(data.shape[1:]))


def _searchsorted_gather(order: torch.Tensor, sk: torch.Tensor,
                         keys: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(build row of each key's match, found) through a sorted index."""
    keys = keys.to(sk.dtype)
    pos = torch.clamp(torch.searchsorted(sk, keys), 0, sk.shape[0] - 1)
    return order[pos], sk[pos] == keys


def pkfk_join(fact: Table, dim: Table, fact_key: str, dim_key: str,
              take: Mapping[str, str]) -> Table:
    """Gather dim columns into the fact table through the PK (sorted
    index). ``take`` maps new-column-name -> dim-column-name. Misses zero
    the mask. The sorted index comes from ``dim.key_index`` (cached)."""
    order, sk = dim.key_index(dim_key)
    rows, found = _searchsorted_gather(order, sk, fact.col(fact_key))
    dim_w = dim.weights()[rows]
    new_cols = {new: dim.col(src)[rows] for new, src in take.items()}
    out = fact.with_columns(**new_cols)
    return Table(out.columns, out.weights() * found.to(F32) * dim_w,
                 out.index_cache)


def pkfk_join_kernel(fact: Table, dim: Table, fact_key: str, dim_key: str,
                     take: Mapping[str, str], *, n_partitions: int = 32,
                     capacity_factor: float = 2.0,
                     mode: Optional[str] = None,
                     residual: bool = True) -> Tuple[Table, torch.Tensor]:
    """PK-FK join probed through the join_probe kernel.

    Both sides are hash-partitioned (hashing.partition_of) into dense
    (P, cap) layouts; the kernel matches each probe slot against its
    partition's build tile and returns the matched build ROW POSITION (as
    f32), through which the ``take`` columns and the build mask are
    gathered. Keys must be non-negative (-1 is the padding). Rows beyond a
    partition's capacity are dropped from the layouts: with ``residual``
    the kernel's misses are re-probed through the sorted path when any
    overflow happened, so the result is exact and the overflow 0; without
    it the overflow is counted and returned. Returns (table, overflow)."""
    fk = fact.col(fact_key).to(torch.int32)
    dk = dim.col(dim_key).to(torch.int32)
    n_fact, n_dim = fk.shape[0], dk.shape[0]
    if max(n_fact, n_dim) >= 1 << 24:
        # row positions ride through the kernel as float32 payloads, exact
        # only below 2^24: refuse rather than corrupt the join
        raise ValueError(f"pkfk_join_kernel limited to <2^24 rows per side, "
                         f"got fact={n_fact}, dim={n_dim}")
    P = n_partitions
    dev = fk.device

    def _layout(keys, cap_rows):
        part = partition_of(keys, P)
        order = torch.argsort(part, stable=True)
        counts = torch.bincount(part, minlength=P)
        starts = torch.cumsum(counts, 0) - counts
        cap = int(max(128, -(-int(cap_rows // P * capacity_factor) // 128)
                      * 128))
        payload = torch.arange(keys.shape[0], dtype=F32, device=dev)
        return pad_partitions(keys[order], payload[order], starts, counts,
                              P, cap)

    # both sides carry their own row positions as the payload
    bkeys, bpos, ovf_b = _layout(dk, n_dim)
    pkeys, prow, ovf_p = _layout(fk, n_fact)
    vals, found = join_probe(bkeys, bpos, pkeys, mode=mode)
    # scatter per-slot results back to row order; padding slots (key -1)
    # all land on a spare row n_fact that is sliced off
    slot_valid = (pkeys >= 0).reshape(-1)
    rows = torch.where(slot_valid, prow.reshape(-1).to(torch.int64), n_fact)
    pos = torch.zeros((n_fact + 1,), dtype=torch.int32, device=dev)
    pos.index_put_((rows,), vals.reshape(-1).to(torch.int32))
    pos = pos[:n_fact]
    found_r = torch.zeros((n_fact + 1,), dtype=torch.bool, device=dev)
    found_r.index_put_((rows,), found.reshape(-1) & slot_valid)
    found_r = found_r[:n_fact]
    overflow = (ovf_b + ovf_p).to(torch.int32)
    if residual:
        # a row dropped by capacity overflow surfaces as found_r == False;
        # re-probing the misses through the exact sorted index restores
        # every match. Only paid when overflow happened (one host sync).
        if int(overflow) > 0:
            order, sk = dim.key_index(dim_key)
            srow, sfound = _searchsorted_gather(order, sk, fk)
            pos = torch.where(found_r, pos, srow.to(torch.int32))
            found_r = found_r | sfound
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    pos = torch.clamp(pos, 0, n_dim - 1).to(torch.int64)
    dim_w = dim.weights()[pos]
    new_cols = {new: dim.col(src)[pos] for new, src in take.items()}
    out = fact.with_columns(**new_cols)
    joined = Table(out.columns, out.weights() * found_r.to(F32) * dim_w,
                   out.index_cache)
    return joined, overflow


# ---------------------------------------------------------------------------
# grouped aggregation: plain segment ops vs the fused-kernel layouts
# ---------------------------------------------------------------------------
def group_aggregate(table: Table, key: str, n_groups: int,
                    aggs: Mapping[str, Tuple[str, str]], *,
                    executor: str = "xla", mode: Optional[str] = None,
                    layout: Optional[str] = None,
                    n_partitions: int = 64, capacity_factor: float = 2.0
                    ) -> Dict[str, torch.Tensor]:
    """aggs: out_name -> (op, column); op in {sum, count, avg, max, min,
    median, distinct, quantile:R}. Masked rows contribute nothing. Returns
    (n_groups,) tensors plus ``_count`` and ``_overflow`` (records beyond
    partition capacity on the partitioned kernel path, else 0).
    ``layout`` overrides the kernel path's dense/partitioned choice."""
    if executor == "xla":
        layout = "xla"
    elif executor != "kernel":
        raise ValueError(f"unknown executor {executor!r}")
    elif layout is None:
        layout = "dense" if n_groups <= DENSE_GROUP_LIMIT else "partitioned"
    keys, vals, src = stacked_columns(table, key, n_groups, aggs)
    sums, overflow = stacked_group_sums(
        keys, vals, n_groups, layout=layout, mode=mode,
        n_partitions=n_partitions, capacity_factor=capacity_factor)
    out = finalize_stacked(
        aggs, src, sums,
        lambda op, col: segment_order_stat(table, keys, n_groups, op, col))
    out["_overflow"] = overflow.to(torch.int32)
    return out


def _zero_i32(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def stacked_columns(table: Table, key: str, n_groups: int,
                    aggs: Mapping[str, Tuple[str, str]]
                    ) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """(keys, stacked values matrix, distinct sum/avg source columns).
    Column 0 carries the selection weights (COUNT)."""
    keys = torch.clamp(table.col(key), 0, n_groups - 1).to(torch.int32)
    w = table.weights()
    src: list = []
    for name, (op, col) in aggs.items():
        if op in ("sum", "avg") and col not in src:
            src.append(col)
        elif (op not in ("sum", "avg", "count", "max", "min")
              and not is_holistic(op)):
            raise ValueError(f"unknown agg op {op!r}")
    vals = torch.stack([w] + [table.col(c).to(F32) * w for c in src], dim=1)
    return keys, vals, src


def stacked_group_sums(keys: torch.Tensor, vals: torch.Tensor, n_groups: int,
                       *, layout: str, mode: Optional[str] = None,
                       n_partitions: int = 64, capacity_factor: float = 2.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group sums of a stacked (N, C) values matrix under one layout.
    Returns ((n_groups, C) sums, overflow)."""
    if layout == "xla":
        return segment_sum(vals, keys, n_groups), _zero_i32(vals.device)
    if layout == "dense":
        return (_fused_dense(keys, vals, n_groups, mode=mode),
                _zero_i32(vals.device))
    if layout == "partitioned":
        sums, overflow = _fused_partitioned(
            keys, vals, n_groups, mode=mode, n_partitions=n_partitions,
            capacity_factor=capacity_factor)
        return sums, overflow.to(torch.int32)
    raise ValueError(f"unknown layout {layout!r}")


def _segment_selection(keys: torch.Tensor, vals: torch.Tensor,
                       n_groups: int):
    """Shared sort pass of the order statistics: per-group value-sorted
    runs plus each run's (count, start). Keys < 0 are EXCLUDED; keys >=
    n_groups clip into the last group. Returns (sorted_vals, counts f32,
    starts int64 shifted past the excluded run, sorted_keys).

    The reference takes the starts as an f32 cumsum of the counts, which
    is inexact once the rows pass 2^24 (and on a card its scan order, so
    its rounding, may vary); the port sums the counts in int64, exactly.
    The two agree wherever the f32 sum is exact. Its spans carry W1's
    names (median.sort, median.counts) for every order statistic."""
    with tracing.span("median.sort", "op"):
        keys = torch.where(keys < 0, -1, torch.clamp(keys, max=n_groups - 1))
        order_v = torch.argsort(vals, stable=True)
        k1, v1 = keys[order_v], vals[order_v]
        order_k = torch.argsort(k1, stable=True)
        sv, sk = v1[order_k], k1[order_k]
    with tracing.span("median.counts", "op"):
        counts = segment_sum(torch.ones_like(keys, dtype=F32),
                             torch.clamp(keys, 0, n_groups - 1), n_groups)
        # excluded records (clipped into group 0 above) leave group 0's count
        n_excl = (keys < 0).sum()
        pad = torch.zeros((n_groups,), dtype=F32, device=keys.device)
        pad[0] = n_excl
        counts = counts - pad
        c64 = counts.to(torch.int64)
        starts = torch.cumsum(c64, 0) - c64 + n_excl
    return sv, counts, starts, sk


def segment_median(keys: torch.Tensor, vals: torch.Tensor, n_groups: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-group median (mean of the two middle elements; NaN for
    empty groups) by sort + selection. Returns (medians, counts)."""
    sv, counts, starts, _sk = _segment_selection(keys, vals, n_groups)
    with tracing.span("median.select", "op"):
        c, s = counts.to(torch.int64), starts.to(torch.int64)
        last = sv.shape[0] - 1
        lo = torch.clamp(s + torch.clamp((c - 1) // 2, min=0), 0, last)
        hi = torch.clamp(s + torch.clamp(c // 2, min=0), 0, last)
        med = (sv[lo] + sv[hi]) * 0.5
        return torch.where(c > 0, med, torch.nan), counts


def segment_quantile(keys: torch.Tensor, vals: torch.Tensor, n_groups: int,
                     rank: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-group ``rank`` quantile with linear interpolation (the
    numpy default); rank in the open interval (0, 1). Keys < 0 are
    excluded, empty groups yield NaN. Returns (quantiles, counts)."""
    if not 0.0 < float(rank) < 1.0:
        raise ValueError(f"quantile rank must be in (0, 1), got {rank}")
    sv, counts, starts, _sk = _segment_selection(keys, vals, n_groups)
    c, s = counts.to(torch.int64), starts.to(torch.int64)
    last = sv.shape[0] - 1
    pos = (torch.tensor(float(rank), dtype=F32, device=sv.device)
           * torch.clamp(c - 1, min=0).to(F32))
    base = torch.floor(pos).to(torch.int64)
    frac = pos - base.to(F32)
    lo = torch.clamp(s + base, 0, last)
    hi = torch.clamp(s + torch.minimum(base + 1, torch.clamp(c - 1, min=0)),
                     0, last)
    q = sv[lo] + (sv[hi] - sv[lo]) * frac
    return torch.where(c > 0, q, torch.nan), counts


def segment_distinct(keys: torch.Tensor, vals: torch.Tensor, n_groups: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-group distinct-value count over the shared selection
    sort: a value counts when it differs from its predecessor in its
    group's sorted run. Keys < 0 excluded; empty groups give 0. Returns
    (distinct f32, counts f32)."""
    sv, counts, _starts, sk = _segment_selection(keys, vals, n_groups)
    prev_k = torch.cat([sk[:1] - 1, sk[:-1]])
    prev_v = torch.cat([sv[:1], sv[:-1]])
    new = (sk >= 0) & ((sk != prev_k) | (sv != prev_v))
    distinct = segment_sum(new.to(F32), torch.clamp(sk, 0, n_groups - 1),
                           n_groups)
    return distinct, counts


def segment_order_stat(table: Table, keys: torch.Tensor, n_groups: int,
                       op: str, col: str) -> torch.Tensor:
    """Masked per-group max/min/median/quantile/distinct (none of them
    are distributive sums, so they never ride the fused sweep)."""
    v = table.col(col).to(F32)
    w = table.weights()
    if op == "median":
        return segment_median(torch.where(w > 0, keys, -1), v, n_groups)[0]
    if op == "distinct":
        return segment_distinct(torch.where(w > 0, keys, -1), v, n_groups)[0]
    rank = parse_quantile(op)
    if rank is not None:
        return segment_quantile(torch.where(w > 0, keys, -1), v, n_groups,
                                rank)[0]
    keys = keys.to(torch.int64)
    if op == "max":
        out = torch.full((n_groups,), -torch.inf, dtype=F32, device=v.device)
        return out.scatter_reduce_(0, keys, torch.where(w > 0, v, -torch.inf),
                                   "amax")
    out = torch.full((n_groups,), torch.inf, dtype=F32, device=v.device)
    return out.scatter_reduce_(0, keys, torch.where(w > 0, v, torch.inf),
                               "amin")


def finalize_stacked(aggs: Mapping[str, Tuple[str, str]], src: list,
                     sums: torch.Tensor,
                     order_stat) -> Dict[str, torch.Tensor]:
    """Named outputs from a merged (n_groups, C) stacked-sums table;
    ``order_stat(op, col)`` supplies the order statistics."""
    cnt = sums[:, 0]
    out: Dict[str, torch.Tensor] = {}
    for name, (op, col) in aggs.items():
        if op == "count":
            out[name] = cnt
        elif op == "sum":
            out[name] = sums[:, 1 + src.index(col)]
        elif op == "avg":
            out[name] = sums[:, 1 + src.index(col)] / torch.clamp(cnt,
                                                                  min=1.0)
        else:
            out[name] = order_stat(op, col)
    out["_count"] = cnt
    return out


def _fused_dense(keys: torch.Tensor, vals: torch.Tensor, n_groups: int, *,
                 mode: Optional[str], block: int = 512) -> torch.Tensor:
    """Small key domain: positional chunking, full-width tables, no sort.
    Each chunk's (n_bins, C) table covers every group, so the result is
    the sum of the chunk tables; padding rows carry zero values. The
    chunk layout is the reference's (8 chunks of a multiple of ``block``
    rows)."""
    N, C = vals.shape
    bins = max(128, -(-n_groups // 128) * 128)
    n_chunks = 8 if N >= 8 * block else 1
    per_chunk = -(-N // n_chunks)
    t = -(-per_chunk // block) * block
    pad = n_chunks * t - N
    k = torch.nn.functional.pad(keys, (0, pad))
    v = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    table = hash_aggregate_multi(k.reshape(n_chunks, t),
                                 v.reshape(n_chunks, t, C),
                                 n_bins=bins, mode=mode)
    return table.sum(dim=0)[:n_groups]


def _fused_partitioned(keys: torch.Tensor, vals: torch.Tensor, n_groups: int,
                       *, mode: Optional[str], n_partitions: int,
                       capacity_factor: float, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large key domain: range partition, then fused per-partition tables.
    The partition-local slot (key % range_size) is collision-free, so the
    result is exact whenever no partition overflows its capacity; the
    overflow is counted and returned. Its spans carry W2's names
    (count.partition, count.aggregate) for every partitioned aggregate."""
    N, C = vals.shape
    range_size = -(-n_groups // n_partitions)
    bins = max(128, -(-range_size // 128) * 128)
    with tracing.span("count.partition", "op"):
        part = torch.clamp(keys // range_size, 0, n_partitions - 1)
        order = torch.argsort(part, stable=True)
        sk, sv = keys[order], take_rows(vals, order)
        with tracing.span("sync:count.bincount", "sync", syncs=2):
            counts_p = torch.bincount(part, minlength=n_partitions)
        starts = torch.cumsum(counts_p, 0) - counts_p
        pad_t = int(max(block,
                        -(-int(N // n_partitions * capacity_factor) // block)
                        * block))
        pk, pv, overflow = pad_partitions(sk, sv, starts, counts_p,
                                          n_partitions, pad_t)
    with tracing.span("count.aggregate", "op"):
        local = torch.where(pk < 0, 0, pk % range_size)  # padded vals are 0
        table = hash_aggregate_multi(local, pv, n_bins=bins, mode=mode)
        flat = table[:, :range_size, :].reshape(n_partitions * range_size, C)
        return flat[:n_groups], overflow
