"""Device-arena allocators: the paper's allocator taxonomy over a byte arena.

A copy of ``repro.memory.allocators`` (pure Python; the port keeps its
own). PyTorch's caching allocator owns device memory, but a serving or
analytics runtime still performs
*logical* allocation constantly: KV-cache pages, hash-table buffers,
partition scratch. These managers implement the paper's allocator designs
(Section 3.1) over a byte arena, with the same mechanics that decide their
scalability on NUMA hosts:

  BumpAllocator   ptmalloc analogue — one global region, one lock, a single
                  first-fit free list. Every operation serializes.
  ArenaAllocator  jemalloc analogue — streams assigned to arenas round-robin;
                  per-arena locks; memory never migrates between arenas
                  (the documented jemalloc limitation).
  SlabAllocator   tbbmalloc/tcmalloc analogue — size-class slabs, per-stream
                  caches (lock-free fast path), batched refill from a central
                  store (lock only on refill/flush).
  HoardAllocator  Hoard analogue — per-stream heaps + a global heap; blocks
                  overflow to the global heap when a stream's free ratio
                  crosses the emptiness threshold.

Concurrency model: callers pass a ``stream`` id (the per-shard / per-request
analogue of a thread). Lock contention is *modeled deterministically*: a
lock acquisition whose previous holder was a different stream counts one
contention event (cache-line transfer analogue). The microbenchmark reports
wall-clock ops/s (real bookkeeping costs differ per design), contention
events, and the paper's memory-overhead ratio (reserved / requested).
"""
from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.config import AllocatorKind


@dataclass
class Block:
    offset: int
    size: int            # rounded (reserved) size
    requested: int       # caller-requested size
    stream: int = 0


@dataclass
class AllocStats:
    allocs: int = 0
    frees: int = 0
    failed: int = 0
    contentions: int = 0
    lock_acquisitions: int = 0
    bytes_requested: int = 0
    bytes_reserved: int = 0
    peak_reserved: int = 0
    live_reserved: int = 0

    def note_alloc(self, requested: int, reserved: int):
        self.allocs += 1
        self.bytes_requested += requested
        self.bytes_reserved += reserved
        self.live_reserved += reserved
        self.peak_reserved = max(self.peak_reserved, self.live_reserved)

    def note_free(self, reserved: int):
        self.frees += 1
        self.live_reserved -= reserved

    @property
    def overhead_ratio(self) -> float:
        if self.bytes_requested == 0:
            return 1.0
        return self.bytes_reserved / self.bytes_requested


class _Lock:
    """Deterministic contention-counting lock."""

    __slots__ = ("holder",)

    def __init__(self):
        self.holder: Optional[int] = None

    def acquire(self, stream: int, stats: AllocStats):
        stats.lock_acquisitions += 1
        if self.holder is not None and self.holder != stream:
            stats.contentions += 1
        self.holder = stream


def _round_up(n: int, granule: int) -> int:
    return -(-n // granule) * granule


_SIZE_CLASSES = [64 << i for i in range(20)]  # 64B .. 32MB


def size_class(n: int) -> int:
    for c in _SIZE_CLASSES:
        if n <= c:
            return c
    return _round_up(n, _SIZE_CLASSES[-1])


class Allocator(abc.ABC):
    kind: AllocatorKind

    def __init__(self, capacity: int, granule: int = 4096):
        self.capacity = capacity
        self.granule = granule
        self.stats = AllocStats()

    @abc.abstractmethod
    def alloc(self, size: int, stream: int = 0) -> Optional[Block]:
        ...

    @abc.abstractmethod
    def free(self, block: Block, stream: int = 0) -> None:
        ...


# ---------------------------------------------------------------------------
class BumpAllocator(Allocator):
    """One lock, one free list, first-fit with top-of-arena bump fallback."""

    kind = AllocatorKind.BUMP

    def __init__(self, capacity: int, granule: int = 4096):
        super().__init__(capacity, granule)
        self._lock = _Lock()
        self._top = 0
        self._free: List[Tuple[int, int]] = []   # (offset, size)

    def alloc(self, size: int, stream: int = 0) -> Optional[Block]:
        self._lock.acquire(stream, self.stats)
        reserved = _round_up(size, self.granule)
        for i, (off, sz) in enumerate(self._free):    # first fit (O(n) walk)
            if sz >= reserved:
                rest = sz - reserved
                if rest:
                    self._free[i] = (off + reserved, rest)
                else:
                    self._free.pop(i)
                self.stats.note_alloc(size, reserved)
                return Block(off, reserved, size, stream)
        if self._top + reserved > self.capacity:
            self.stats.failed += 1
            return None
        off = self._top
        self._top += reserved
        self.stats.note_alloc(size, reserved)
        return Block(off, reserved, size, stream)

    def free(self, block: Block, stream: int = 0) -> None:
        self._lock.acquire(stream, self.stats)
        self._free.append((block.offset, block.size))
        self.stats.note_free(block.size)


# ---------------------------------------------------------------------------
class ArenaAllocator(Allocator):
    """Round-robin arenas, per-arena locks + size-class free lists."""

    kind = AllocatorKind.ARENA

    def __init__(self, capacity: int, granule: int = 4096, n_arenas: int = 8):
        super().__init__(capacity, granule)
        self.n_arenas = n_arenas
        per = capacity // n_arenas
        self._locks = [_Lock() for _ in range(n_arenas)]
        self._tops = [i * per for i in range(n_arenas)]
        self._limits = [(i + 1) * per for i in range(n_arenas)]
        self._free: List[Dict[int, List[int]]] = [dict() for _ in range(n_arenas)]
        self._assignment: Dict[int, int] = {}
        self._next = 0

    def _arena_of(self, stream: int) -> int:
        if stream not in self._assignment:
            self._assignment[stream] = self._next % self.n_arenas
            self._next += 1
        return self._assignment[stream]

    def alloc(self, size: int, stream: int = 0) -> Optional[Block]:
        a = self._arena_of(stream)
        self._locks[a].acquire(stream, self.stats)
        cls = size_class(max(size, self.granule))
        lst = self._free[a].get(cls)
        if lst:
            off = lst.pop()
            self.stats.note_alloc(size, cls)
            return Block(off, cls, size, stream)
        if self._tops[a] + cls > self._limits[a]:
            self.stats.failed += 1
            return None
        off = self._tops[a]
        self._tops[a] += cls
        self.stats.note_alloc(size, cls)
        return Block(off, cls, size, stream)

    def free(self, block: Block, stream: int = 0) -> None:
        # memory never moves between arenas: freed into the OWNER's arena
        a = self._arena_of(block.stream)
        self._locks[a].acquire(stream, self.stats)
        self._free[a].setdefault(block.size, []).append(block.offset)
        self.stats.note_free(block.size)


# ---------------------------------------------------------------------------
class SlabAllocator(Allocator):
    """Size-class slabs + per-stream caches; central store refills in
    batches of ``batch`` blocks (the tcmalloc/tbbmalloc fast path)."""

    kind = AllocatorKind.SLAB

    def __init__(self, capacity: int, granule: int = 4096, batch: int = 16):
        super().__init__(capacity, granule)
        self.batch = batch
        self._central_lock = _Lock()
        self._top = 0
        self._central: Dict[int, List[int]] = {}
        self._caches: Dict[int, Dict[int, List[int]]] = {}

    def _cache(self, stream: int) -> Dict[int, List[int]]:
        return self._caches.setdefault(stream, {})

    def alloc(self, size: int, stream: int = 0) -> Optional[Block]:
        cls = size_class(max(size, self.granule))
        cache = self._cache(stream).setdefault(cls, [])
        if not cache:                                  # refill (locked)
            self._central_lock.acquire(stream, self.stats)
            central = self._central.setdefault(cls, [])
            take = min(self.batch, len(central))
            cache.extend(central[-take:])
            del central[len(central) - take:]
            while len(cache) < self.batch:
                if self._top + cls > self.capacity:
                    break
                cache.append(self._top)
                self._top += cls
        if not cache:
            self.stats.failed += 1
            return None
        off = cache.pop()
        self.stats.note_alloc(size, cls)
        return Block(off, cls, size, stream)

    def free(self, block: Block, stream: int = 0) -> None:
        cache = self._cache(stream).setdefault(block.size, [])
        cache.append(block.offset)                     # lock-free fast path
        self.stats.note_free(block.size)
        if len(cache) > 2 * self.batch:                # flush half (locked)
            self._central_lock.acquire(stream, self.stats)
            half = len(cache) // 2
            self._central.setdefault(block.size, []).extend(cache[:half])
            del cache[:half]


# ---------------------------------------------------------------------------
class HoardAllocator(Allocator):
    """Per-stream heaps with an emptiness threshold that returns surplus
    free blocks to a global heap (bounds blowup, costs a global lock)."""

    kind = AllocatorKind.HOARD

    def __init__(self, capacity: int, granule: int = 4096,
                 empty_fraction: float = 0.5):
        super().__init__(capacity, granule)
        self.empty_fraction = empty_fraction
        self._global_lock = _Lock()
        self._global: Dict[int, List[int]] = {}
        self._top = 0
        self._heaps: Dict[int, Dict[int, List[int]]] = {}
        self._live: Dict[int, int] = {}
        self._cached: Dict[int, int] = {}

    def _heap(self, stream: int) -> Dict[int, List[int]]:
        return self._heaps.setdefault(stream, {})

    def alloc(self, size: int, stream: int = 0) -> Optional[Block]:
        cls = size_class(max(size, self.granule))
        heap = self._heap(stream).setdefault(cls, [])
        if not heap:
            self._global_lock.acquire(stream, self.stats)
            glob = self._global.setdefault(cls, [])
            if glob:
                heap.append(glob.pop())
            elif self._top + cls <= self.capacity:
                heap.append(self._top)
                self._top += cls
        if not heap:
            self.stats.failed += 1
            return None
        off = heap.pop()
        self._cached[stream] = self._cached.get(stream, 0) - cls
        self._live[stream] = self._live.get(stream, 0) + cls
        self.stats.note_alloc(size, cls)
        return Block(off, cls, size, stream)

    def free(self, block: Block, stream: int = 0) -> None:
        heap = self._heap(stream).setdefault(block.size, [])
        heap.append(block.offset)
        self._live[stream] = self._live.get(stream, 0) - block.size
        self._cached[stream] = self._cached.get(stream, 0) + block.size
        self.stats.note_free(block.size)
        live = max(self._live.get(stream, 0), 0)
        cached = self._cached.get(stream, 0)
        if cached > self.granule * 8 and cached > self.empty_fraction * (live + cached):
            self._global_lock.acquire(stream, self.stats)   # return surplus
            self._global.setdefault(block.size, []).append(heap.pop())
            self._cached[stream] -= block.size


ALLOCATORS = {
    AllocatorKind.BUMP: BumpAllocator,
    AllocatorKind.ARENA: ArenaAllocator,
    AllocatorKind.SLAB: SlabAllocator,
    AllocatorKind.HOARD: HoardAllocator,
}


def make_allocator(kind: AllocatorKind, capacity: int,
                   granule: int = 4096, **kw) -> Allocator:
    return ALLOCATORS[kind](capacity, granule, **kw)
