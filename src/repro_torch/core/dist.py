"""A communicator over ``torch.distributed``: one process per rank.

The multi-process counterpart of ``core.vmesh``. ``DistCommunicator``
offers the methods of ``vmesh.Communicator`` with the same semantics
(``psum``, ``pmax``, ``pmin``, ``psum_scatter``, ``all_gather`` and
``all_to_all``, all tiled on dimension 0, ``axis_index``, ``rank``,
``n``), over a process group that the caller initializes
(``process_group`` below, or ``torch.distributed.init_process_group``
with a timeout). ``DistMesh(group).run(fn, inputs)`` has the shape of
``VirtualMesh.run``: it calls ``fn(comm, inputs[rank])`` for this
process's rank and returns a list of n entries that holds the result at
``rank`` and None elsewhere, so code written for the virtual mesh runs
unchanged, each process reading its own entry.

Which torch.distributed call carries each collective:

  psum, pmax, pmin   floats: ``all_gather_into_tensor`` of chunks of at
                     most CHUNK_BYTES a rank, combined in RANK order, so
                     the sum has the virtual mesh's bits (a ring
                     ``all_reduce`` adds in an order of its own); integers
                     and bools: ``all_reduce``, which is exact;
  psum_scatter       ``all_to_all_single``, then a sum of the n received
                     blocks in rank order (no ``reduce_scatter``: it
                     would not add in rank order, and gloo lacks it for
                     some tensor kinds);
  all_gather         ``all_gather_into_tensor``;
  all_to_all         ``all_to_all_single`` with equal splits.

Tensors stay on their device: a CUDA tensor goes to the collective as it
is (NCCL, or gloo's CUDA path), never through the host. A psum, pmax or
pmin keeps its input's memory layout, as the virtual mesh's elementwise
combine does, so that a later reduction over it (AdamW's global norm)
adds in the same order. ``traffic``
counts, per torch.distributed call, the calls made and the bytes this
rank handed to them (the payload; what crosses a link depends on the
backend's algorithm and on n, and is 0 at n = 1).
"""
from __future__ import annotations

import contextlib
import datetime
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 600.0      # seconds a collective may wait for its peers
CHUNK_BYTES = 1 << 26        # a float psum gathers at most this much a rank


def _integral(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex())


class DistCommunicator:
    """This process's handle on the group's collectives (the reference's
    ``axis``)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed has no process group: "
                               "initialize one first (process_group)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.traffic: Dict[str, Dict[str, int]] = {}

    def _count(self, call: str, x: torch.Tensor) -> None:
        t = self.traffic.setdefault(call, {"calls": 0, "bytes": 0})
        t["calls"] += 1
        t["bytes"] += x.numel() * x.element_size()

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` in rank order."""
        flat = x.reshape(-1).contiguous()
        out = flat.new_empty(self.n * flat.numel())
        self._count("all_gather_into_tensor", flat)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        return out.view((self.n,) + tuple(x.shape))

    @staticmethod
    def _like(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out`` (contiguous, x's shape) in x's memory layout, as the
        virtual mesh's elementwise combine leaves it: a later reduction
        over the result then adds in the same order."""
        if x.is_contiguous():
            return out
        return torch.empty_like(x).copy_(out)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", out)
        dist.all_reduce(out, op=op, group=self.group)
        return self._like(x, out)

    def _combine(self, x: torch.Tensor, fn) -> torch.Tensor:
        """fn over the ranks' ``x`` in rank order, a chunk at a time, into
        a tensor of x's memory layout. A contiguous ``x`` goes in flat
        chunks, any other in chunks of rows along dimension 0, so that a
        chunk's copy (and every temporary) is a chunk in size."""
        out = torch.empty_like(x)
        if x.is_contiguous():
            src, dst = x.view(-1), out.view(-1)
        else:
            src, dst = x, out
        row = src[0].numel() * x.element_size() if src.numel() else 1
        step = max(1, CHUNK_BYTES // max(1, row))
        for lo in range(0, src.shape[0], step):
            parts = self._gather(src[lo:lo + step])
            acc = parts[0]
            for p in parts[1:]:
                acc = fn(acc, p)
            dst[lo:lo + step].copy_(acc)
        return out

    # -- jax.lax collectives -----------------------------------------------
    def axis_index(self) -> int:
        return self.rank

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if _integral(x):
            return self._all_reduce(x, dist.ReduceOp.SUM)
        return self._combine(x, torch.add)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if _integral(x):
            return self._all_reduce(x, dist.ReduceOp.MAX)
        return self._combine(x, torch.maximum)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        if _integral(x):
            return self._all_reduce(x, dist.ReduceOp.MIN)
        return self._combine(x, torch.minimum)

    def _split_rows(self, x: torch.Tensor, what: str) -> int:
        if x.dim() == 0 or x.shape[0] % self.n:
            raise ValueError(f"{what}: {tuple(x.shape)[:1]} rows do not "
                             f"split into {self.n} shards")
        return x.shape[0] // self.n

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self._count("all_to_all_single", x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``psum_scatter(x, scatter_dimension=0, tiled=True)``."""
        k = self._split_rows(x, "psum_scatter")
        recv = self._all_to_all(x)
        out = recv[:k]
        for i in range(1, self.n):
            out = out + recv[i * k:(i + 1) * k]
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather(x, tiled=True)``."""
        parts = self._gather(x)
        return parts.flatten(0, 1) if x.dim() else parts

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``."""
        self._split_rows(x, "all_to_all")
        return self._all_to_all(x)


class DistMesh:
    """The process group as a mesh of one axis, this process one rank of
    it."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.comm = DistCommunicator(group)
        self.n = self.comm.n
        self.rank = self.comm.rank

    @property
    def local_ranks(self) -> Sequence[int]:
        """The ranks this process runs: its own."""
        return (self.rank,)

    def run(self, fn: Callable[[DistCommunicator, Any], Any],
            inputs: Sequence[Any]) -> List[Any]:
        """``fn(comm, inputs[rank])`` at index ``rank`` of an n-list, None
        at the other ranks' indices (their processes hold theirs)."""
        if len(inputs) != self.n:
            raise ValueError(f"{len(inputs)} inputs for {self.n} ranks")
        out: List[Any] = [None] * self.n
        out[self.rank] = fn(self.comm, inputs[self.rank])
        return out


@contextlib.contextmanager
def process_group(backend: str, *, rank: int, world_size: int,
                  init_method: Optional[str] = None,
                  store: Optional[dist.Store] = None,
                  timeout: float = DEFAULT_TIMEOUT) -> Iterator[DistMesh]:
    """``torch.distributed.init_process_group`` with a timeout of
    ``timeout`` seconds on every collective, the group's mesh for the
    block, and the group destroyed on exit. ``init_method`` is e.g.
    ``tcp://127.0.0.1:<port>``; ``store`` a ``dist.FileStore`` or
    ``dist.TCPStore``; one of the two."""
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield DistMesh()
    finally:
        dist.destroy_process_group()
