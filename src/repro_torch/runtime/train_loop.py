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
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _build(paths, grads))

    def train_step(params, opt_state, batch, step):
        lr = schedules.warmup_cosine(
            torch.tensor(step, dtype=torch.int32, device=model.device),
            peak_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
            total_steps=total_steps)
        if accum > 1:
            acc_dtype = getattr(torch, tcfg.grad_accum_dtype)
            paths, shapes = zip(*((p, v.shape) for p, v in _flatten(params)))
            acc = [torch.zeros(shape, dtype=acc_dtype, device=model.device)
                   for shape in shapes]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            n = next(iter(batch.values())).shape[0] // accum
            for i in range(accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, _, grads = value_and_grad(params, mb)
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
