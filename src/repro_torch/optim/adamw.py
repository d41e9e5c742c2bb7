"""AdamW, the counterpart of ``repro.optim.adamw``.

The same state (``AdamWState(step, mu, nu, master)``, fields in the
reference's order, so that checkpoints interchange) and the same
arithmetic: global-norm clipping, bias corrections, decoupled weight decay
on the float32 master copy, moments stored in ``moment_dtype``. The port
runs on one device, so the placement policy that shards the state in the
reference has nothing to place here.

``update`` works one leaf at a time and in place: the moments, the master
copy and the parameters are the state's own tensors, overwritten with
their new values (each operation in the reference's order), so that the
peak stays a few leaf-sized temporaries above the state. The tensors of
``params`` and of the state passed in are the ones returned.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any
    master: Optional[Any]   # fp32 master weights (None = update in place)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (the reference's
    ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def init(params: Any, cfg: TrainConfig) -> AdamWState:
    mdtype = _dtype(cfg.moment_dtype)
    mu = _map(lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device),
              params)
    nu = _map(lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device),
              params)
    master = (_map(lambda p: p.detach().to(torch.float32, copy=True), params)
              if cfg.master_weights else None)
    dev = next(leaves(params)).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), mu, nu,
                      master)


def abstract_state(params_abs: Any, cfg: TrainConfig) -> AdamWState:
    """``init``'s state as ``meta`` tensors (shape and dtype, no storage),
    from the parameters' (e.g. ``core.params.abstract_params``)."""
    mdtype = _dtype(cfg.moment_dtype)

    def like(dtype):
        return lambda p: torch.empty(p.shape, dtype=dtype, device="meta")
    master = (_map(like(torch.float32), params_abs)
              if cfg.master_weights else None)
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      _map(like(mdtype), params_abs),
                      _map(like(mdtype), params_abs), master)


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def update(grads: Any, state: AdamWState, params: Any, lr: torch.Tensor,
           cfg: TrainConfig) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step; returns (params, state, {"grad_norm", "clip"}) with
    the parameters and the state's tensors updated in place."""
    with torch.no_grad():
        step = state.step + 1
        gnorm = global_norm(grads)
        clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
                if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        use_master = state.master is not None
        master = state.master if use_master else params
        for g, m, v, p, pm in zip(leaves(grads), leaves(state.mu),
                                  leaves(state.nu), leaves(params),
                                  leaves(master)):
            gf = g.float() * clip
            # m * b1 + gf * (1 - b1), into m itself when it is float32
            mf = m.float().mul_(b1).add_(gf * (1 - b1))
            gf.square_().mul_(1 - b2)
            vf = v.float().mul_(b2).add_(gf)
            del gf
            # mhat / (sqrt(vhat) + eps) + wd * base; base - lr * that
            stepv = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
            base = pm.float()
            stepv.add_(cfg.weight_decay * base)
            new_master = base.sub_(lr * stepv)
            del stepv
            for dst, src in ((m, mf), (v, vf), (pm, new_master),
                             (p, new_master)):
                if dst is not src:
                    dst.copy_(src)
        metrics = {"grad_norm": gnorm, "clip": clip}
        return params, AdamWState(step, state.mu, state.nu,
                                  state.master if use_master else None), \
            metrics
