"""A virtual mesh: n shards of one SPMD program on one device.

The port's stand-in for the reference's jax ``Mesh`` + ``shard_map`` +
``jax.lax`` collectives. ``VirtualMesh(n, device).run(fn, inputs)`` calls
``fn(comm, inputs[i])`` for every shard i, each in a thread of its own,
and returns the n results. Per-shard code is written as the reference's
SPMD code is: where the reference calls ``jax.lax.psum(x, axis)``, the
port calls ``comm.psum(x)`` with the same meaning.

Collectives meet at a ``threading.Barrier``. Each shard posts its tensor
to its rank's slot of the collective, waits for every shard, then reads
all slots. The semantics are those of ``jax.lax`` over the mesh axis:

  psum / pmax / pmin       elementwise over the shards, combined in RANK
                           order, so a float psum gives the same bits on
                           every run and every shard;
  psum_scatter             (tiled, scatter dimension 0) the psum, of which
                           shard i keeps row block i;
  all_gather               (tiled) the shards' tensors concatenated along
                           dimension 0 in rank order;
  all_to_all               (split 0, concat 0, tiled) shard j receives row
                           block j of every shard i, concatenated in source
                           rank order;
  axis_index               the shard's rank (``comm.rank``).

The shards take turns on the interpreter: a shard runs until its next
collective, then waits there while another runs. With one runnable Python
thread the shards do not trade the interpreter lock at every launch; the
work they queue on the device still runs back to back. All shards launch
on the caller's current stream of one device, so stream order carries
every handoff: a tensor one shard posts was enqueued before any shard
reads it. Every shard must call the same collectives in the same order, as
under ``shard_map``; a shard that calls another collective, or returns
while others still wait, fails the run with an error instead of hanging.
An exception in any shard aborts the barrier, so no shard waits forever,
and ``run`` re-raises it in the caller. Each wait is bounded by
``timeout`` seconds.

All shards' buffers are alive at once, so the device holds about n times
one shard's buffers. ``core.dist`` offers the same methods over
``torch.distributed``, one process per rank.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

DEFAULT_TIMEOUT = 600.0      # seconds a shard may wait at one collective


class MeshError(RuntimeError):
    """A shard of a virtual mesh failed, timed out, or broke the SPMD
    contract (another collective, or fewer collectives, than its peers)."""


class _Aborted(MeshError):
    """A shard left its collective because the barrier broke: a peer
    failed (its own error is the one to report) or the wait timed out."""


class _Shared:
    """State the shards of one ``run`` share: the barrier, the turn (held
    by the one shard that runs), and, per collective, the slots the shards
    post to."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.barrier = threading.Barrier(n)
        self.turn = threading.Lock()
        self.lock = threading.Lock()
        self.slots: Dict[int, List[Any]] = {}


class Communicator:
    """One shard's handle on the mesh's collectives (the reference's
    ``axis``)."""

    def __init__(self, shared: _Shared, rank: int):
        self._shared = shared
        self.rank = rank
        self.n = shared.n
        self._calls = 0
        self._has_turn = False

    def _take_turn(self) -> None:
        if not self._shared.turn.acquire(timeout=self._shared.timeout):
            raise _Aborted(f"shard {self.rank}: timed out waiting for its "
                           "turn")
        self._has_turn = True

    def _give_turn(self) -> None:
        if self._has_turn:
            self._has_turn = False
            self._shared.turn.release()

    # -- the exchange every collective is built on -------------------------
    def _exchange(self, kind: str, x: Any) -> List[Any]:
        """Post ``x`` for collective number ``self._calls`` and return every
        shard's post, in rank order, once all have posted."""
        sh = self._shared
        call = self._calls
        self._calls += 1
        with sh.lock:
            slots = sh.slots.setdefault(call, [None] * sh.n)
        slots[self.rank] = (kind, x)
        self._give_turn()
        try:
            sh.barrier.wait(sh.timeout)
        except threading.BrokenBarrierError:
            raise _Aborted(f"shard {self.rank}: the mesh was aborted or "
                           f"timed out at collective {call} ({kind})"
                           ) from None
        self._take_turn()
        # every shard has posted ``call``, so all have read ``call - 1``
        if self.rank == 0:
            with sh.lock:
                sh.slots.pop(call - 1, None)
        kinds = {k for k, _ in slots}
        if len(kinds) != 1:          # every shard sees it and raises
            raise MeshError(f"shards disagree at collective {call}: "
                            f"{[k for k, _ in slots]}")
        return [v for _, v in slots]

    # -- jax.lax collectives -----------------------------------------------
    def axis_index(self) -> int:
        return self.rank

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange("psum", x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange("pmax", x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange("pmin", x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.minimum(out, p)
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``psum_scatter(x, scatter_dimension=0, tiled=True)``: dimension
        0 must be a multiple of n."""
        if x.shape[0] % self.n:
            raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split "
                             f"into {self.n} shards")
        parts = self._exchange("psum_scatter", x)
        k = x.shape[0] // self.n
        lo = self.rank * k
        out = parts[0][lo:lo + k]
        for p in parts[1:]:
            out = out + p[lo:lo + k]
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather(x, tiled=True)``."""
        return torch.cat(self._exchange("all_gather", x), dim=0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``:
        dimension 0 must be a multiple of n."""
        if x.shape[0] % self.n:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"into {self.n} shards")
        parts = self._exchange("all_to_all", x)
        k = x.shape[0] // self.n
        lo = self.rank * k
        return torch.cat([p[lo:lo + k] for p in parts], dim=0)

    def _finish(self) -> None:
        """The end of the shard's program: a last meeting, so a shard that
        returns while its peers wait at a collective fails the run."""
        self._exchange("exit", None)


class VirtualMesh:
    """n shards of one program on one device, one thread per shard, one
    shard running at a time between collectives."""

    def __init__(self, n: int, device: Union[None, str, torch.device] = None,
                 timeout: float = DEFAULT_TIMEOUT):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        self.n = n
        self.device = torch.device(device) if device is not None else None
        self.timeout = timeout

    @property
    def local_ranks(self) -> Sequence[int]:
        """The ranks this process runs: all of them."""
        return tuple(range(self.n))

    def run(self, fn: Callable[[Communicator, Any], Any],
            inputs: Sequence[Any]) -> List[Any]:
        """``[fn(comm_i, inputs[i]) for each shard i]``, the shards taking
        turns between collectives. Raises the first shard's exception (or
        a ``MeshError``) in the caller."""
        if len(inputs) != self.n:
            raise ValueError(f"{len(inputs)} inputs for {self.n} shards")
        shared = _Shared(self.n, self.timeout)
        results: List[Any] = [None] * self.n
        errors: List[Optional[BaseException]] = [None] * self.n
        stream = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)

        def shard(rank: int) -> None:
            comm = Communicator(shared, rank)
            try:
                comm._take_turn()
                if stream is None:
                    results[rank] = fn(comm, inputs[rank])
                else:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        results[rank] = fn(comm, inputs[rank])
                comm._finish()
            except BaseException as e:          # re-raised by run()
                errors[rank] = e
                shared.barrier.abort()
            finally:
                comm._give_turn()

        threads = [threading.Thread(target=shard, args=(r,),
                                    name=f"vmesh-shard-{r}", daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if e is not None and not isinstance(e, _Aborted)),
                     None) or next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


def shard_rows(tree: Dict[str, Dict[str, torch.Tensor]],
               n: int) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Split every column of a {table: {column: tensor}} mapping into n
    contiguous row blocks, shard i taking block i (``shard_map``'s
    ``P(axis)``). Row counts must be multiples of n."""
    out: List[Dict[str, Dict[str, torch.Tensor]]] = [{} for _ in range(n)]
    for t, cols in tree.items():
        for c, a in cols.items():
            if a.shape[0] % n:
                raise ValueError(f"{t}.{c}: {a.shape[0]} rows do not split "
                                 f"into {n} shards")
            per = a.shape[0] // n
            for i in range(n):
                out[i].setdefault(t, {})[c] = a[i * per:(i + 1) * per]
    return out
