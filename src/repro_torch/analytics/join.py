"""W3 (hash join) and W4 (index nested-loop join) operators: the port of
``repro.analytics.join``.

W3: both sides are hash-partitioned (``hashing.partition_of``) into dense
(P, capacity) layouts, builds padded with key -1 and probes with -2, and
the join_probe kernel probes each partition; on a CUDA tensor it launches
the CUDA ``join_probe``.

W4: a pre-built read-only index accelerates the lookups. Three index
kinds, each a build and a probe of plain tensor operations (the radix
probe a kernel on a CUDA tensor):
  radix_index   bucket directory on a hash prefix + sorted runs (the
                paper's ART)
  sorted_index  binary search over the sorted keys (B+Tree leaves /
                SkipList)
  hash_index    open-addressing linear-probe table (Masstree's lookups)
A join returns the microbenchmark's aggregate: match count and value
checksum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.analytics import tracing
from repro_torch.analytics.hashing import (multiply_shift, pad_partitions,
                                           partition_of)
from repro_torch.kernels.join_probe import join_probe
from repro_torch.kernels.radix_probe import radix_probe

F32 = torch.float32


# ---------------------------------------------------------------------------
# W3: partitioned hash join
# ---------------------------------------------------------------------------
def hash_join(build_keys: torch.Tensor, build_vals: torch.Tensor,
              probe_keys: torch.Tensor, *, n_partitions: int = 64,
              capacity_factor: float = 2.0, mode: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PK-FK join. Returns (match_count int64, value_checksum f32,
    overflow int32): the records beyond a partition's capacity on either
    side, which are dropped from the layouts and counted, never silently
    lost."""
    def layout(keys, vals, pad_key):
        n = keys.shape[0]
        part = partition_of(keys, n_partitions)
        order = torch.argsort(part, stable=True)
        with tracing.span("sync:hash_join.bincount", "sync", syncs=2):
            counts = torch.bincount(part, minlength=n_partitions)
        starts = torch.cumsum(counts, 0) - counts
        pad_t = int(max(128, -(-int(n // n_partitions * capacity_factor)
                               // 128) * 128))
        return pad_partitions(keys[order], vals[order], starts, counts,
                              n_partitions, pad_t, pad_key=pad_key)

    with tracing.span("hash_join", "op"):
        with tracing.span("hash_join.layout", "op", side="build"):
            bk, bv, ovf_b = layout(build_keys, build_vals.to(F32), -1)
        with tracing.span("hash_join.layout", "op", side="probe"):
            pk, _, ovf_p = layout(probe_keys,
                                  torch.ones_like(probe_keys, dtype=F32), -2)
        with tracing.span("hash_join.probe", "op"):
            vals, found = join_probe(bk, bv, pk, mode=mode)
            return found.sum(), vals.sum(), (ovf_b + ovf_p).to(torch.int32)


# ---------------------------------------------------------------------------
# W4: index joins
# ---------------------------------------------------------------------------
class RadixIndex(NamedTuple):
    """ART analogue: a radix directory over hash prefixes + sorted runs."""
    sorted_keys: torch.Tensor     # (R,) sorted by (bucket, key)
    sorted_vals: torch.Tensor
    bucket_starts: torch.Tensor   # (n_buckets + 1,) int64
    bits: int


def build_radix_index(keys: torch.Tensor, vals: torch.Tensor, *,
                      bits: int = 10) -> RadixIndex:
    bucket = multiply_shift(keys, bits)
    # two stable sorts: ordered by (bucket, key) without a 64-bit key
    order_k = torch.argsort(keys, stable=True)
    k1, v1, b1 = keys[order_k], vals[order_k], bucket[order_k]
    order_b = torch.argsort(b1, stable=True)
    with tracing.span("sync:radix_index.bincount", "sync", syncs=2):
        counts = torch.bincount(bucket, minlength=1 << bits)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return RadixIndex(k1[order_b], v1[order_b], starts, bits)


def probe_radix_index(index: RadixIndex, probe_keys: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket lookup, then a lower bound within the bucket's run: the
    radix_probe kernel on a CUDA tensor, its plain version (a fixed-trip
    binary search, every probe key stepping at once) on the CPU."""
    return radix_probe(index.sorted_keys, index.sorted_vals,
                       index.bucket_starts, index.bits, probe_keys)


class SortedIndex(NamedTuple):
    """B+Tree-leaf / SkipList analogue: binary search over sorted keys."""
    sorted_keys: torch.Tensor
    sorted_vals: torch.Tensor


def build_sorted_index(keys: torch.Tensor, vals: torch.Tensor
                       ) -> SortedIndex:
    order = torch.argsort(keys, stable=True)
    return SortedIndex(keys[order], vals[order])


def probe_sorted_index(index: SortedIndex, probe_keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    pos = torch.searchsorted(index.sorted_keys, probe_keys)
    pos = torch.clamp(pos, 0, index.sorted_keys.shape[0] - 1)
    found = index.sorted_keys[pos] == probe_keys
    return torch.where(found, index.sorted_vals[pos], 0.0), found


class HashIndex(NamedTuple):
    """Open-addressing linear-probe table (Masstree analogue for lookups)."""
    table_keys: torch.Tensor      # (capacity,) int32, -1 = empty
    table_vals: torch.Tensor
    capacity: int
    max_probes: int


def build_hash_index(keys: torch.Tensor, vals: torch.Tensor, *,
                     load_factor: float = 0.5,
                     max_probes: int = 16) -> HashIndex:
    """Vectorised linear-probe insertion: each round, every unplaced key
    bids for its next slot and a scatter-max arbitrates (the highest key
    wins a contested empty slot), the data-parallel form of the CAS loop a
    CPU table runs. Keys still unplaced after ``max_probes`` rounds are
    left out, as in the reference. Losing bids and non-winners write to a
    spare slot ``cap`` that is sliced off."""
    R = keys.shape[0]
    cap = 1 << max(4, int((R / load_factor) - 1).bit_length())
    dev = keys.device
    keys, vals = keys.to(torch.int32), vals.to(F32)
    tk = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    tv = torch.zeros((cap + 1,), dtype=F32, device=dev)
    home = multiply_shift(keys) % cap
    placed = torch.zeros_like(keys, dtype=torch.bool)
    for i in range(max_probes):
        want = (home + i) % cap                       # this round's bid
        bidding = ~placed & (tk[want] == -1)
        slot_bid = torch.where(bidding, want, cap)
        bids = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
        bids.scatter_reduce_(0, slot_bid, keys, "amax")
        won = bidding & (bids[want] == keys)
        target = torch.where(won, want, cap)
        tk[target] = keys
        tv[target] = vals
        placed |= won
    return HashIndex(tk[:cap], tv[:cap], cap, max_probes)


def probe_hash_index(index: HashIndex, probe_keys: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    cap = index.capacity
    slot = multiply_shift(probe_keys) % cap
    found = torch.zeros_like(probe_keys, dtype=torch.bool)
    vals = torch.zeros_like(probe_keys, dtype=F32)
    for i in range(index.max_probes):
        s = (slot + i) % cap
        hit = (index.table_keys[s] == probe_keys) & ~found
        vals = torch.where(hit, index.table_vals[s], vals)
        found = found | hit
    return vals, found


_INDEX_KINDS = {
    "radix": (build_radix_index, probe_radix_index),
    "sorted": (build_sorted_index, probe_sorted_index),
    "hash": (build_hash_index, probe_hash_index),
}


def index_join(build_keys: torch.Tensor, build_vals: torch.Tensor,
               probe_keys: torch.Tensor, index_kind: str = "radix"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W4: pre-built-index join -> (match_count int64, value_checksum f32)."""
    if index_kind not in _INDEX_KINDS:
        raise ValueError(f"unknown index kind {index_kind!r}")
    build, probe = _INDEX_KINDS[index_kind]
    with tracing.span("index_join", "op", kind=index_kind):
        with tracing.span("index.build", "op", kind=index_kind):
            index = build(build_keys, build_vals)
        with tracing.span("index.probe", "op", kind=index_kind):
            vals, found = probe(index, probe_keys)
            return found.sum(), vals.sum()
