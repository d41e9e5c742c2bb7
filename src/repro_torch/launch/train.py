"""Training launcher.

The counterpart of ``repro.launch.train``: the same arguments and the same
JSON keys, plus ``--device`` (the CUDA device unless ``cpu``; it raises
when there is no card, like every entry point of the port).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir "$TMPDIR/ckpt"
  PYTHONPATH=src python -m repro_torch.launch.train --arch \
      recurrentgemma-2b --reduced --steps 12 --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.core.config import (LM_SHAPES, PlacementPolicy, RunConfig,
                                     ShardingConfig, TrainConfig,
                                     resolve_device)
from repro_torch.models.lm import LMModel
from repro_torch.runtime import FailureInjector, train


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU execution")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--policy", default="interleave",
                    choices=[p.value for p in PlacementPolicy])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT drill)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train as the arguments say; print and return the JSON summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = make_reduced(arch)
    cfg = RunConfig(
        arch=arch, shape=LM_SHAPES["train_4k"],
        sharding=ShardingConfig(policy=PlacementPolicy(args.policy)),
        train=TrainConfig(learning_rate=args.lr, accum_steps=args.accum,
                          warmup_steps=max(2, args.steps // 10)))
    model = LMModel(arch, remat="block", device=device)
    injector = FailureInjector(fail_at_steps=args.fail_at) if args.fail_at \
        else None
    res = train(model, cfg, n_steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
                injector=injector)
    out = {
        "arch": arch.name, "steps": res.steps_run,
        "first_loss": res.losses[0] if res.losses else None,
        "final_loss": res.final_loss, "restarts": res.restarts,
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
