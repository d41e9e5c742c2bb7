"""Paged KV-cache manager: serving state allocated through the paper's
allocators, with the THP analogue (page size) as a first-class knob.

Pages hold ``page_tokens`` tokens of K/V for every layer (vLLM-style block
table). Small pages (16 tokens ~ "4KB") minimize internal fragmentation on
short/ragged sequences but multiply allocator traffic and page-table
entries; large pages (512 tokens ~ "2MB" hugepages) invert the tradeoff —
exactly the paper's Section 3.4.1 tension, measurable here as
(fragmentation ratio, allocator ops, page-table length).

Device-side layout per layer: (n_pages, page_tokens, kv_heads, head_dim);
``gather_sequence`` materializes a contiguous view through the page table
(the serve loop's attention input).

The counterpart of ``repro.memory.paged_kv``: the manager is host-side
Python, copied; ``gather_sequence`` is PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.config import AllocatorKind
from repro_torch.memory.allocators import make_allocator


@dataclass
class SequenceState:
    seq_id: int
    length: int = 0
    pages: List[int] = field(default_factory=list)
    blocks: List[object] = field(default_factory=list)


class PagedKVManager:
    """Host-side page-table manager. Page ids index the device pool."""

    def __init__(self, n_pages: int, page_tokens: int, page_bytes: int,
                 allocator: AllocatorKind = AllocatorKind.SLAB):
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        # pages must be allocator-granule aligned: power-of-two, >= 4 KiB —
        # size-class rounding then never splits or straddles a page
        pb = max(page_bytes, 4096)
        self.page_bytes = 1 << (pb - 1).bit_length()
        kw = {}
        if allocator == AllocatorKind.SLAB:
            # page pools are small relative to slab refill batches; a large
            # batch lets per-stream caches hoard the pool (the paper's
            # tbbmalloc memory-consumption tradeoff) — keep refills small
            kw["batch"] = 2
        self.alloc = make_allocator(allocator,
                                    capacity=n_pages * self.page_bytes,
                                    granule=self.page_bytes, **kw)
        self.sequences: Dict[int, SequenceState] = {}
        self._failed_appends = 0

    # ------------------------------------------------------------------
    def add_sequence(self, seq_id: int) -> SequenceState:
        st = SequenceState(seq_id)
        self.sequences[seq_id] = st
        return st

    def append_tokens(self, seq_id: int, n: int, stream: int = 0) -> bool:
        """Reserve room for ``n`` new tokens; allocates pages on demand."""
        st = self.sequences[seq_id]
        needed_pages = -(-(st.length + n) // self.page_tokens)
        while len(st.pages) < needed_pages:
            blk = self.alloc.alloc(self.page_bytes, stream=stream)
            if blk is None:
                self._failed_appends += 1
                return False
            page_id = blk.offset // self.page_bytes
            st.pages.append(page_id)
            st.blocks.append(blk)
        st.length += n
        return True

    def release_sequence(self, seq_id: int, stream: int = 0) -> None:
        st = self.sequences.pop(seq_id)
        for blk in st.blocks:
            self.alloc.free(blk, stream=stream)

    # ------------------------------------------------------------------
    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        st = self.sequences[seq_id]
        table = np.full((max_pages,), -1, np.int32)
        table[:len(st.pages)] = st.pages[:max_pages]
        return table

    def fragmentation_ratio(self) -> float:
        """Reserved tokens / live tokens (paper Fig 2b analogue)."""
        live = sum(st.length for st in self.sequences.values())
        reserved = sum(len(st.pages) for st in self.sequences.values()) \
            * self.page_tokens
        return reserved / max(live, 1)

    @property
    def allocator_stats(self):
        return self.alloc.stats


def gather_sequence(pool: torch.Tensor, page_table: torch.Tensor,
                    length: torch.Tensor) -> torch.Tensor:
    """Materialize a contiguous (max_tokens, ...) KV view via the page table.

    pool: (n_pages, page_tokens, ...); page_table: (max_pages,) int32.
    Entries past ``length`` are zeroed.
    """
    pages = torch.clamp(page_table.long(), 0, pool.shape[0] - 1)
    gathered = pool[pages]                       # (max_pages, page_tokens, ...)
    flat = gathered.reshape((-1,) + tuple(pool.shape[2:]))
    pos = torch.arange(flat.shape[0], device=pool.device)
    mask = (pos < length).reshape((-1,) + (1,) * (flat.ndim - 1))
    return torch.where(mask, flat, torch.zeros((), dtype=flat.dtype,
                                               device=flat.device))
