"""Host data pipeline: synthetic token streams with prefetch.

The counterpart of ``repro.data.pipeline``, the same numpy draws bit for
bit: each host makes only its shard of the global batch (host_id), a
background thread keeps ``prefetch`` batches ahead, and every batch is
deterministic in (seed, step), so a restart resumes mid-stream exactly
(fault tolerance needs replayable data). Batches are numpy arrays; the
train loop moves them to its device.

Modality stubs: musicgen batches carry precomputed frame embeddings;
qwen2-vl batches carry patch embeddings and 3D M-RoPE positions.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.core.config import ArchConfig


def _rng_for(seed: int, step: int, host_id: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + step * 9_973 + host_id)
                                 % (2**31 - 1))


def synth_batch(arch: ArchConfig, batch: int, seq: int, *, step: int,
                seed: int = 0, host_id: int = 0) -> Dict[str, np.ndarray]:
    """One host-local batch. Labels are next-token shifted ids."""
    rng = _rng_for(seed, step, host_id)
    if arch.n_codebooks:
        embeds = rng.randn(batch, seq, arch.d_model).astype(np.float32) * 0.02
        labels = rng.randint(0, arch.vocab_size,
                             (batch, seq, arch.n_codebooks)).astype(np.int32)
        return {"embeds": embeds, "labels": labels}
    ids = rng.randint(0, arch.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    if arch.vlm:
        P = arch.n_patches
        n_text = seq - P
        out["tokens"] = ids[:, :n_text]
        out["labels"] = ids[:, 1:n_text + 1]
        out["patch_embeds"] = rng.randn(batch, P, arch.d_model).astype(
            np.float32) * 0.02
        grid = int(np.ceil(np.sqrt(P)))
        hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
        pos = np.stack([np.zeros_like(hh), hh, ww],
                       axis=-1).reshape(-1, 3)[:P]
        out["patch_pos"] = np.broadcast_to(pos, (batch, P, 3)).astype(np.int32)
    return out


class PrefetchingLoader:
    """Background-thread prefetcher over synth_batch (double buffering).
    ``close()`` stops and joins the thread."""

    def __init__(self, arch: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2,
                 transform=None):
        self.arch, self.batch, self.seq = arch, batch, seq
        self.seed, self.host_id = seed, host_id
        self.step = start_step
        self.transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            b = synth_batch(self.arch, self.batch, self.seq, step=step,
                            seed=self.seed, host_id=self.host_id)
            if self.transform is not None:
                b = self.transform(b)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        step, b = self._q.get()
        return b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
