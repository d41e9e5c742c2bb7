"""Explicit data-parallel train step with compressed gradient sync.

The counterpart of ``repro.runtime.dp_step``. The batch is split into
row blocks, one a rank (``shard_map``'s ``P(axis)``). Each rank takes the
loss of its block and its gradients against the shared parameters
(``torch.autograd.grad``, as ``train_loop`` takes them), the loss is
averaged over the ranks, and the gradients are either averaged (pmean) or
synced through ``optim.compression`` (int8 blocks with error feedback).
AdamW then updates the parameters once, in place. There is no gradient
accumulation and no bfloat16 cast: the reference's DP step has neither.

``mesh`` is a ``core.vmesh.VirtualMesh`` (every rank a thread of this
process, on one device) or a ``core.dist.DistMesh`` (this process one
rank of a ``torch.distributed`` group). Each rank keeps a residual tree
of its own, as each device of the reference's ``shard_map`` keeps its own
(``errors`` goes in and out with ``P()`` and ``check_rep=False``, so it is
never made equal across devices): ``errors`` is a list of n trees on the
virtual mesh and this process's tree under ``torch.distributed``. The
residuals are updated in place. They are ignored, and may be None, when
compression is off.

A pmean is a psum times n's float32 reciprocal: ``jax.lax.pmean`` divides
by a constant, which XLA turns into that product under ``jit``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.core.config import RunConfig
from repro_torch.core.vmesh import VirtualMesh
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw, compression, schedules
from repro_torch.runtime.train_loop import _build, _flatten


def _pmean(comm, x: torch.Tensor) -> torch.Tensor:
    return comm.psum(x) * (1.0 / comm.n)


def make_dp_train_step(model: LMModel, cfg: RunConfig, mesh, *,
                       total_steps: int = 10_000) -> Callable:
    """Returns step(params, opt_state, errors, batch, step) ->
    (params, opt_state, errors, metrics), metrics {"loss", "lr",
    "grad_norm", "clip"}. The mesh has one axis (the reference names it
    with ``axis``; a one-axis mesh needs no name); every batch leaf's
    leading dim must split into ``mesh.n`` blocks."""
    tcfg = cfg.train
    compress = cfg.sharding.gradient_compression
    n = mesh.n

    def sharded_part(params, comm, block):
        batch, errors = block
        paths, leaves = zip(*((p, v.detach().requires_grad_())
                              for p, v in _flatten(params)))
        loss, _ = model.loss_fn(_build(paths, leaves), batch,
                                z_loss=tcfg.z_loss)
        # a parameter the loss does not reach gets a zero gradient, as
        # under the reference's jax.grad (train_loop's value_and_grad)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        del leaves
        loss = _pmean(comm, loss.detach())
        resid = [e for _, e in _flatten(errors)] if compress else None
        for i, g in enumerate(grads):
            # each leaf synced as it comes, over the local grad's memory
            if compress:
                grads[i] = compression.compress_leaf(g, resid[i], comm,
                                                     out=g)[0]
            else:
                grads[i] = _pmean(comm, g)
            del g
        return loss, _build(paths, grads)

    def step(params, opt_state, errors, batch, step_idx):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} ranks")
        per = rows // n
        local = list(mesh.local_ranks)
        if compress:
            own: List[Any] = errors if isinstance(errors, list) else [errors]
            if len(own) != len(local):
                raise ValueError(f"{len(own)} residual trees for the "
                                 f"{len(local)} ranks of this process")
        blocks: List[Any] = [None] * n
        for j, r in enumerate(local):
            blocks[r] = ({k: v[r * per:(r + 1) * per]
                          for k, v in batch.items()},
                         own[j] if compress else None)
        outs = mesh.run(lambda comm, b: sharded_part(params, comm, b),
                        blocks)
        # every rank holds the same synced loss and grads: take the first
        loss, grads = outs[local[0]]
        del outs
        lr = schedules.warmup_cosine(
            torch.tensor(step_idx, dtype=torch.int32,
                         device=loss.device),
            peak_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
            total_steps=total_steps)
        new_params, new_opt, opt_metrics = adamw.update(
            grads, opt_state, params, lr, tcfg)
        metrics: Dict[str, Any] = {"loss": loss, "lr": lr, **opt_metrics}
        return new_params, new_opt, errors, metrics

    return step


def init_error_feedback(params: Any, mesh=None) -> Any:
    """Float32 zeros of the parameters' shapes: one tree, or, on a
    ``VirtualMesh``, a list of one tree per rank."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    if isinstance(mesh, VirtualMesh):
        return [zeros(params) for _ in range(mesh.n)]
    return zeros(params)
