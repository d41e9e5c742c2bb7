"""Gradient compression for the data-parallel all-reduce.

The counterpart of ``repro.optim.compression``: int8 block quantization
with error feedback. Each rank adds its residual to its gradient, scales
each block of ``block`` values by the block's max |value| / 127 and rounds
to int8 (half to even, as ``jnp.round``). The ranks' int8 values are
summed as int32 (an int8 sum would overflow past 127 ranks) and their
scales summed in float32; the synced gradient is the dequantized MEAN of
the quantized values times the MEAN of the scales,
dequant(sum q_i / n, sum scale_i / n), which is not sum q_i * scale_i / n.
What this rank's contribution lost, target - dequant(q, scale), is its
residual for the next step.

The psum rides int32: 4 bytes a value, plus 4 bytes a block for the
scales, against 4 bytes a value for a float32 psum and 2 for a bfloat16
one. The reference's "4x fewer wire bytes than bf16" would need an int8
psum; this scheme moves about twice a bfloat16 psum's bytes.

The arithmetic is the reference's under ``jax.jit`` on the CPU, bit for
bit: XLA turns the division by the constant 127 into a product with its
float32 reciprocal, keeps the divisions by the scales and by n (a psum,
not a constant), and fuses the residual's product and difference into one
rounding (``_residual``). A CUDA division by a host scalar is a product
with its reciprocal, so n divides as a tensor on the gradient's device.

Each leaf is processed in chunks of about CHUNK_BLOCKS whole blocks, cut
along its first dimension (``row_chunks``). Blocks are independent, so
the chunks give the unchunked bits, and a leaf's temporaries stay a chunk
in size, also for a gradient whose memory layout is not row-major
(recurrentgemma-2b's embedding gradient, 655M values, 2.4 GiB in
float32, comes transposed from the tied head's product).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

CHUNK_BLOCKS = 1 << 16          # 16M values, 64 MiB of float32, a chunk
# float32(1 / 127): what XLA multiplies by where the reference divides by
# 127.0 under jit
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (N,), scales float32 (N / block,)) of x flattened and padded
    with zeros to a whole block."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) * _INV_127,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.view(-1), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], block: int = 256) -> torch.Tensor:
    """The first prod(shape) values of q * scale (per block), as shape."""
    blocks = q.float().view(-1, block) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.view(-1)[:n].view(tuple(shape))


def _residual(target: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              block: int) -> torch.Tensor:
    """target - dequant(q, scale) with ONE rounding: XLA's CPU code
    contracts the reference's product and difference into a fused
    multiply-add. In float64 the product (8 x 24 bits) and the difference
    (|residual| <= scale / 2 <= |target| + scale) are exact, so rounding
    the difference to float32 gives the fused bits on any device."""
    prod = q.double().view(-1, block) * scale.double()[:, None]
    return (target.double() - prod.view(-1)[:target.numel()]).float()


def row_chunks(shape: Sequence[int], block: int = 256
               ) -> List[Tuple[int, int]]:
    """Chunks of a leaf of ``shape``: (first, last) index ranges along dim
    0 (a 0-d leaf is one row) of about CHUNK_BLOCKS blocks each, every
    chunk but the last a whole number of blocks of the flattened leaf,
    so that blocks never straddle two chunks."""
    shape = tuple(shape) or (1,)
    row = 1
    for d in shape[1:]:
        row *= d
    unit = block // math.gcd(row, block) if row else 1
    rows = max(unit, CHUNK_BLOCKS * block // max(row, 1) // unit * unit)
    return [(r, min(shape[0], r + rows))
            for r in range(0, max(1, shape[0]), rows)]


def compress_leaf(g: torch.Tensor, e: torch.Tensor, comm, block: int = 256,
                  out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf's compressed psum over ``comm`` (a ``vmesh`` or ``dist``
    communicator): (synced gradient in g's dtype, residual). The residual
    is written over ``e`` (float32, g's shape, contiguous) in place; the
    synced gradient goes to ``out`` (g's shape, any layout; it may be
    ``g`` itself) or a new tensor. The leaf goes in ``row_chunks``, so
    its temporaries, a non-contiguous leaf's copies included, stay a
    chunk in size. Every rank makes the same collectives: two psums a
    chunk."""
    if e.dtype != torch.float32 or e.shape != g.shape or \
            not e.is_contiguous():
        raise ValueError(f"residual {e.dtype} {tuple(e.shape)} is not a "
                         f"contiguous float32 tensor of {tuple(g.shape)}")
    if out is None:
        out = torch.empty_like(g)
    n = torch.full((), float(comm.n), device=g.device)
    rows = [x.view(1) if x.dim() == 0 else x for x in (g, out)]
    ef = e.view(-1)
    row = ef.numel() // max(1, rows[0].shape[0])
    for r0, r1 in row_chunks(g.shape, block):
        lo, hi = r0 * row, r1 * row
        target = rows[0][r0:r1].reshape(-1).float() + ef[lo:hi]
        q, scale = quantize_int8(target, block)
        summed = comm.psum(q.to(torch.int32))
        scale_sum = comm.psum(scale)
        deq = dequantize_int8(summed.float() / n, scale_sum / n,
                              rows[1][r0:r1].shape, block)
        ef[lo:hi] = _residual(target, q, scale, block)
        rows[1][r0:r1] = deq
    return out, e


def _map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts, keys in sorted order (so every
    rank makes its collectives in one order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def compressed_psum(grads: Any, comm, errors: Optional[Any] = None,
                    block: int = 256) -> Tuple[Any, Any]:
    """On one rank: psum each grad leaf (a nested dict of tensors, or one
    tensor) in int8 with error feedback -> (synced grads, residuals).
    ``errors`` (float32 zeros of the grads' shapes when None) is updated
    in place and returned; the synced grads are new tensors."""
    if errors is None:
        errors = _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)
    synced = _map(lambda g, e: compress_leaf(g, e, comm, block)[0], grads,
                  errors)
    return synced, errors
