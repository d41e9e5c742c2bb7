"""Training runtime: step builder and fault-tolerant loop.

The counterpart of ``repro.runtime.train_loop``. ``make_train_step``
builds the step:
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
with the reference's semantics: the lr from ``warmup_cosine`` (step 0 has
lr 0, so it leaves the master weights as they were), gradient
accumulation over ``accum_steps`` microbatches summed in
``grad_accum_dtype``, divided, then cast to bfloat16, and AdamW. The
gradient is ``torch.autograd.grad`` of ``model.loss_fn`` with respect to
detached aliases of the parameters, so the optimizer updates the
parameters' own tensors in place.

On DTensor parameters and opt state (``launch.sharding_plan.distribute``)
the same step is the sharded one, the counterpart of the reference's jit
with in and out shardings: the batch is placed by ``batch_specs`` on the
parameters' mesh, the step runs under DTensor's implicit replication,
AdamW returns the parameters in their own placements and the state in
its own (``optim.adamw``), and the metrics come back whole.

``train`` is the driving loop: seeded data, async checkpoints, step
timing, straggler tracking, and checkpoint/restart on (injected or real)
failures, on the model's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.core.config import RunConfig
from repro_torch.data.pipeline import synth_batch
from repro_torch.kernels.common import is_sharded, replicating
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw, schedules
from repro_torch.runtime.ft import (FailureInjector, SimulatedFailure,
                                    StragglerDetector)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_flatten(v, prefix + (k,)) if isinstance(v, dict)
                   else [(prefix + (k,), v)])
    return out


def _build(paths: List[Tuple[str, ...]], vals) -> Dict[str, Any]:
    """The nested dict with ``vals`` at ``paths``."""
    out: Dict[str, Any] = {}
    for path, v in zip(paths, vals):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def make_train_step(model: LMModel, cfg: RunConfig,
                    total_steps: int = 10_000) -> Callable:
    tcfg = cfg.train
    accum = tcfg.accum_steps

    def value_and_grad(params, batch):
        paths, leaves = zip(*((p, v.detach().requires_grad_())
                              for p, v in _flatten(params)))
        loss, metrics = model.loss_fn(_build(paths, leaves), batch,
                                      z_loss=tcfg.z_loss)
        # a parameter the loss does not reach (the audio stub's codebook
        # embeddings, when the batch brings frame embeddings) gets a zero
        # gradient, as under the reference's jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _build(paths, grads))

    def train_step(params, opt_state, batch, step):
        leaf = _flatten(params)[0][1]
        if is_sharded(leaf):
            with replicating(params):
                new_params, new_opt, metrics = run_step(
                    params, opt_state, _place_batch(batch, leaf, cfg), step)
            return new_params, new_opt, {
                k: v.full_tensor() if is_sharded(v) else v
                for k, v in metrics.items()}
        return run_step(params, opt_state, batch, step)

    def run_step(params, opt_state, batch, step):
        # a factory, not torch.tensor: on the dry run's fake tensors the
        # step stays fake, where a tensor made from data would be a real
        # one on the card that the schedule's operators then run on
        lr = schedules.warmup_cosine(
            torch.full((), step, dtype=torch.int32, device=model.device),
            peak_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
            total_steps=total_steps)
        if accum > 1:
            acc_dtype = getattr(torch, tcfg.grad_accum_dtype)
            paths, shapes = zip(*((p, v.shape) for p, v in _flatten(params)))
            sharded = is_sharded(_flatten(params)[0][1])
            acc = None if sharded else [
                torch.zeros(shape, dtype=acc_dtype, device=model.device)
                for shape in shapes]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for i in range(accum):
                mb = {k: _microbatch(v, i, accum) for k, v in batch.items()}
                loss, _, grads = value_and_grad(params, mb)
                if acc is None:     # zeros placed as the grads (partial sums)
                    acc = [torch.zeros_like(g, dtype=acc_dtype)
                           for _, g in _flatten(grads)]
                for a, (_, g) in zip(acc, _flatten(grads)):
                    a.add_(g)
                loss_sum = loss_sum + loss
            grads = _build(paths, [(a / accum).to(torch.bfloat16)
                                   for a in acc])
            loss = loss_sum / accum
            aux_metrics: Dict[str, torch.Tensor] = {}
        else:
            loss, aux_metrics, grads = value_and_grad(params, batch)
        new_params, new_opt, opt_metrics = adamw.update(
            grads, opt_state, params, lr, tcfg)
        metrics = {"loss": loss, "lr": lr, **opt_metrics, **aux_metrics}
        return new_params, new_opt, metrics

    return train_step


def _microbatch(v: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum``: rows [i n, (i + 1) n) of the batch;
    of a DTensor, those of each rank's block (so that every microbatch
    stays split over the data axes, as the reference's reshape to
    (accum, B / accum) leaves it), the same rows when it is whole."""
    if not is_sharded(v):
        n = v.shape[0] // accum
        return v[i * n:(i + 1) * n]
    from torch.distributed.tensor import DTensor
    local = v.to_local()
    n = local.shape[0] // accum
    shape = (v.shape[0] // accum,) + tuple(v.shape[1:])
    return DTensor.from_local(local[i * n:(i + 1) * n], v.device_mesh,
                              v.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _place_batch(batch: Dict[str, torch.Tensor], leaf,
                 cfg: RunConfig) -> Dict[str, Any]:
    """``batch`` (every rank's whole batch, or DTensors already) as
    DTensors on ``leaf``'s mesh, placed by ``batch_specs``."""
    from repro_torch.core.partitioning import MeshSpec
    from repro_torch.launch.sharding_plan import batch_specs, distribute
    if all(is_sharded(v) for v in batch.values()):
        return batch
    mesh = leaf.device_mesh
    spec = MeshSpec(mesh.mesh_dim_names, tuple(mesh.shape))
    b, s = next(iter(batch.values())).shape[:2]
    shape = dataclasses.replace(cfg.shape, global_batch=b, seq_len=s)
    if cfg.arch.vlm and "patch_embeds" in batch:
        shape = dataclasses.replace(shape, seq_len=s + cfg.arch.n_patches)
    shardings = batch_specs(cfg.arch, shape, spec,
                            cfg.sharding.strategy)["shardings"]
    return distribute(batch, {k: shardings[k] for k in batch}, mesh)


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: list
    restarts: int
    straggler_events: int


def train(model: LMModel, cfg: RunConfig, *, n_steps: int,
          batch: int, seq: int, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 0, seed: int = 0,
          injector: Optional[FailureInjector] = None,
          param_dtype: torch.dtype = torch.float32) -> TrainResult:
    """The fault-tolerant training loop on the model's device: parameters
    drawn from ``seed``, batches from ``synth_batch(seed, step)``."""
    step_fn = make_train_step(model, cfg, total_steps=n_steps)
    mgr = CheckpointManager(ckpt_dir) if (ckpt_dir and ckpt_every) else None
    detector = StragglerDetector(n_hosts=1)

    def fresh_state():
        params = model.init_params(seed, param_dtype)
        return params, adamw.init(params, cfg.train)

    params, opt_state = fresh_state()
    start = 0
    if mgr is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            params, opt_state = restore(ckpt_dir, last, (params, opt_state))
            start = last

    losses, restarts, step = [], 0, start
    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            b = {k: torch.from_numpy(v).to(model.device) for k, v in
                 synth_batch(model.arch, batch, seq, step=step,
                             seed=seed).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, b, step)
            loss = float(metrics["loss"])
            detector.record(0, time.perf_counter() - t0)
            losses.append(loss)
            step += 1
            if mgr is not None and step % ckpt_every == 0:
                mgr.save_async(step, (params, opt_state))
        except SimulatedFailure:
            restarts += 1
            if mgr is not None:
                mgr.wait()
                last = latest_step(ckpt_dir)
                if last is not None:
                    params, opt_state = restore(ckpt_dir, last,
                                                (params, opt_state))
                    step = last
                else:
                    params, opt_state = fresh_state()
                    step = 0
            else:
                params, opt_state = fresh_state()
                step = 0
    if mgr is not None:
        mgr.wait()
    return TrainResult(steps_run=step,
                       final_loss=losses[-1] if losses else float("nan"),
                       losses=losses, restarts=restarts,
                       straggler_events=len(detector.stragglers()))
