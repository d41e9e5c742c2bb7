"""Serving runtime: continuous batching over a paged KV budget.

The counterpart of ``repro.runtime.serve_loop``, with the same admission,
preemption and statistics. Wave-based continuous batching: a fixed device
batch of ``wave_slots`` decode lanes; requests are admitted into free
lanes whenever the paged KV manager can reserve their pages (admission
control = the allocator; the page-size knob moves fragmentation and
admission latency). Completed sequences release pages at once, admitting
queued work.

The device-side cache is wave-static (slots x max_len) while the manager
tracks logical pages. Every wave decodes all ``wave_slots`` lanes with
``LMModel.decode_step`` (occupied or not), so the cache's length advances
for every lane on every wave, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.core.config import AllocatorKind
from repro_torch.memory.paged_kv import PagedKVManager
from repro_torch.models.lm import LMModel


@dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0
    done: bool = False


@dataclass
class ServeStats:
    steps: int = 0
    tokens_out: int = 0
    admitted: int = 0
    completed: int = 0
    admission_stalls: int = 0
    lane_utilization: float = 0.0
    fragmentation: float = 0.0


class ContinuousBatcher:
    def __init__(self, model: LMModel, params, *, wave_slots: int,
                 max_len: int, page_tokens: int, n_pages: int,
                 allocator: AllocatorKind = AllocatorKind.SLAB,
                 kv_bytes_per_token: int = 2):
        self.model = model
        self.params = params
        self.wave_slots = wave_slots
        self.max_len = max_len
        self.kv = PagedKVManager(
            n_pages=n_pages, page_tokens=page_tokens,
            page_bytes=page_tokens * kv_bytes_per_token,
            allocator=allocator)
        self.lanes: List[Optional[Request]] = [None] * wave_slots
        self.queue: List[Request] = []
        self.cache = model.init_cache(wave_slots, max_len)
        self.stats = ServeStats()
        # every wave feeds zeros: token ids, or the codebooks' codes
        C = model.arch.n_codebooks
        self._wave = ({"codes": torch.zeros((wave_slots, 1, C),
                                            dtype=torch.int32,
                                            device=model.device)}
                      if C else
                      {"tokens": torch.zeros((wave_slots, 1),
                                             dtype=torch.int32,
                                             device=model.device)})

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.wave_slots):
            if self.lanes[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            self.kv.add_sequence(req.req_id)
            if not self.kv.append_tokens(req.req_id, req.prompt_len,
                                         stream=i):
                self.kv.release_sequence(req.req_id)
                self.stats.admission_stalls += 1
                return  # head-of-line blocked: wait for pages
            self.queue.pop(0)
            self.lanes[i] = req
            self.stats.admitted += 1

    @torch.no_grad()
    def step(self) -> None:
        """One decode wave across all occupied lanes."""
        self._admit()
        occupied = [i for i, r in enumerate(self.lanes) if r is not None]
        if not occupied:
            return
        _, self.cache = self.model.decode_step(self.params, self.cache,
                                               self._wave)
        self.stats.steps += 1
        self.stats.lane_utilization += len(occupied) / self.wave_slots
        for i in occupied:
            req = self.lanes[i]
            if not self.kv.append_tokens(req.req_id, 1, stream=i):
                # out of pages mid-flight: preempt (requeue), the
                # capacity-pressure case
                self.kv.release_sequence(req.req_id)
                self.queue.insert(0, dataclasses.replace(req, generated=0))
                self.lanes[i] = None
                self.stats.admission_stalls += 1
                continue
            req.generated += 1
            self.stats.tokens_out += 1
            if req.generated >= req.max_new_tokens:
                req.done = True
                self.kv.release_sequence(req.req_id)
                self.lanes[i] = None
                self.stats.completed += 1
        # track PEAK fragmentation (end-state is trivially 0 after releases)
        self.stats.fragmentation = max(self.stats.fragmentation,
                                       self.kv.fragmentation_ratio())

    def run(self, max_steps: int = 1_000) -> ServeStats:
        for _ in range(max_steps):
            if not self.queue and all(l is None for l in self.lanes):
                break
            self.step()
        if self.stats.steps:
            self.stats.lane_utilization /= self.stats.steps
        return self.stats
