"""Kernel dispatch: hand-written CUDA kernel | plain PyTorch version.

The counterpart of ``repro.kernels.common``. There is no interpret mode:
a CUDA kernel runs on the card or not at all. The modes are

  * mode="auto":  the CUDA kernel for a tensor on a CUDA device, the plain
                  PyTorch version for a tensor on the CPU;
  * mode="cuda":  force the CUDA kernel (a CPU tensor then raises);
  * mode="ref":   force the plain PyTorch version.

Set globally via env REPRO_TORCH_KERNEL_MODE or per call with ``mode``.
The choice follows the tensor's device, never the machine: a CUDA tensor
under "auto" launches the kernel or raises, it never falls back.

Each LM kernel's launch is an operator of the ``repro_torch`` library
(``torch.library``): a CUDA implementation that builds, launches and
counts, a fake one that gives the outputs' shapes and dtypes, and a FLOP
formula (``torch.utils.flop_counter``), so that a trace on fake tensors
(``launch.dryrun``) sees each launch with no build and no launch.

On DTensors (the sharded step) each LM kernel runs on every rank's block
(``on_shards``). Its sharding rule (``ShardRule``) names the dims it may
be split along, one role a mesh axis (batch; heads or width), each other
axis replicated; the wrapper takes the rule's placement on each mesh axis
from its first input, redistributes the inputs to it, and runs its
autograd Function on the local blocks (``local_map``), so that the
forward and the backward both see plain tensors and launch the kernel on
them. The operators themselves only ever see local tensors.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

ENV_VAR = "REPRO_TORCH_KERNEL_MODE"
_VALID = ("auto", "cuda", "ref")


def kernel_mode(mode: Optional[str] = None,
                device: Optional[torch.device] = None) -> str:
    """Resolve ``mode`` to "cuda" or "ref" for data on ``device``.

    Without a device, "auto" stays "auto" (the planner asks before any
    tensor exists)."""
    mode = mode or os.environ.get(ENV_VAR, "auto")
    if mode not in _VALID:
        raise ValueError(f"kernel mode {mode!r} not in {_VALID}")
    if mode == "auto" and device is not None:
        return "cuda" if torch.device(device).type == "cuda" else "ref"
    return mode


# Launch counts of the hand-written kernels. Each wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels (chip_smoke.py zeroes them around the main path).
# The shards of a virtual mesh launch from threads, hence the lock.
LAUNCHES = {"hash_aggregate_multi": 0, "join_probe": 0,
            "block_histograms": 0, "flash_attention": 0, "rglru_scan": 0,
            "wkv6": 0}
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


# Calls of the LM kernels on DTensors, each through its sharding rule
# (``on_shards``): the sharded step's route, counted beside the launches;
# and of the plain steps that run on local blocks the same way: the
# one-token decode attention, which has no kernel, and MLA's assembly of
# per-head q, k and v and its absorbed decode.
SHARDED_CALLS = {"flash_attention": 0, "rglru_scan": 0, "wkv6": 0,
                 "decode_attention": 0, "mla_heads": 0, "mla_decode": 0}


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for counts in (LAUNCHES, SHARDED_CALLS):
            for name in counts:
                counts[name] = 0


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple, device: torch.device,
                contiguous: bool = True) -> None:
    """Raise unless ``t`` is what a CUDA kernel takes: a tensor of
    ``dtype`` and ``shape`` on the CUDA device ``device``, contiguous (or,
    with ``contiguous=False``, contiguous in its last dim). A fake tensor
    (the dry run's, on any device) stands for the card's."""
    if t.device != device or not (device.type == "cuda"
                                  or isinstance(t, FakeTensor)):
        raise ValueError(f"{name} must lie on {device}, a CUDA device; "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the integer handle a C
    launcher takes."""
    return torch.cuda.current_stream(device).cuda_stream


def pick_block(size: int, preferred: int, minimum: int = 8) -> int:
    """Largest divisor-block <= preferred for a dimension of ``size``."""
    b = min(preferred, size)
    while size % b and b > minimum:
        b -= 1
    return max(b, 1) if size % max(b, 1) == 0 else size


class ShardRule:
    """Where a kernel's tensors may be split: ``roles`` maps a role
    ("batch", "heads", ...) to the dim each tensor input splits along for
    it (None: replicated under that role) and ``outputs`` to each output's
    (None: replicated). A mesh axis either replicates every tensor or
    splits them all along one role's dims."""

    def __init__(self, name: str, roles: Dict[str, Sequence[Optional[int]]],
                 outputs: Dict[str, Sequence[int]]):
        self.name = name
        self.roles = {k: tuple(v) for k, v in roles.items()}
        self.outputs = {k: tuple(v) for k, v in outputs.items()}

    def _one(self, role: Optional[str], n_in: int):
        """(output placements, input placements) of one mesh axis."""
        from torch.distributed.tensor import Replicate, Shard
        if role is None:
            return ([Replicate()] * len(next(iter(self.outputs.values()))),
                    [Replicate()] * n_in)
        return ([Replicate() if d is None else Shard(d)
                 for d in self.outputs[role]],
                [Replicate() if d is None else Shard(d)
                 for d in self.roles[role]])

    def choose(self, tensors: Sequence[torch.Tensor]
               ) -> Tuple[list, list, list]:
        """(output placements, input placements, input gradients'
        placements) over every mesh axis: on each, the role along whose
        dim the first input is split there if every input's size along
        that role's dim divides by the axis' size, else replication. An
        input that a role leaves whole while others split (WKV6's ``u``
        under batch) gets a partial gradient there: each rank's is its
        block's share of the sum."""
        from torch.distributed.tensor import Partial
        first = tensors[0]
        mesh = first.device_mesh
        per_axis = []
        for m, p in enumerate(first.placements):
            size = mesh.size(m)
            role = None
            for r, dims in self.roles.items():
                if p.is_shard() and p.dim == dims[0] and all(
                        d is None or t.shape[d] % size == 0
                        for t, d in zip(tensors, dims)):
                    role = r
            outs, ins = self._one(role, len(tensors))
            grads = list(ins)
            if role is not None:
                grads = [Partial() if d is None else pl
                         for pl, d in zip(ins, self.roles[role])]
            per_axis.append((outs, ins, grads))
        n_out = len(per_axis[0][0])
        outs = [[a[0][j] for a in per_axis] for j in range(n_out)]
        ins = [[a[1][i] for a in per_axis] for i in range(len(tensors))]
        grads = [[a[2][i] for a in per_axis] for i in range(len(tensors))]
        return outs, ins, grads


def is_sharded(*ts) -> bool:
    """True when any of ``ts`` is a DTensor: the sharded step's route. No
    DTensor exists before ``torch.distributed.tensor`` is imported, so the
    plain route leaves that package (~530 modules) unimported."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and any(isinstance(t, dtensor.DTensor)
                                       for t in ts)


_REPLICATING = threading.local()


@contextlib.contextmanager
def replicating(tree):
    """DTensor's implicit replication while ``tree`` (a dict of tensors)
    holds a DTensor, so that plain tensors the step makes (positions,
    masks, scalars) stand for replicated ones; otherwise nothing. Nested
    entries leave it to the outermost."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()), None)
    if not is_sharded(tree) or getattr(_REPLICATING, "on", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATING.on = True
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.on = False


def on_shards(fn: Callable, rule: ShardRule, tensors: Sequence,
              rest: Sequence = ()):
    """``fn(*tensors, *rest)`` on each rank's blocks of the DTensors
    ``tensors`` (``rest``: plain arguments), placed by ``rule.choose``:
    the inputs are redistributed to the rule's placements, ``fn`` runs on
    the local tensors (its autograd Function's forward and backward
    alike) and its outputs come back as DTensors in the rule's output
    placements."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
    tensors = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in tensors]
    outs, ins, grads = rule.choose(tensors)
    with _LAUNCH_LOCK:
        SHARDED_CALLS[rule.name] += 1
    wrapped = local_map(fn, out_placements=outs[0] if len(outs) == 1 else
                        tuple(outs),
                        in_placements=tuple(ins) + (None,) * len(rest),
                        in_grad_placements=tuple(grads) + (None,) * len(rest),
                        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*tensors, *rest)

