"""Serving launcher: continuous batching with a paged KV budget.

The counterpart of ``repro.launch.serve``: the same arguments and the same
JSON statistics, plus ``--device`` (the CUDA device unless ``cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      recurrentgemma-2b --requests 32 --wave-slots 8 --max-new 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced as make_reduced
from repro_torch.core.config import AllocatorKind, ArchConfig
from repro_torch.models.lm import LMModel
from repro_torch.runtime import ContinuousBatcher, Request


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--wave-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="THP analogue: tokens per KV page")
    ap.add_argument("--n-pages", type=int, default=512)
    ap.add_argument("--allocator", default="slab",
                    choices=[a.value for a in AllocatorKind])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, params: Optional[Dict[str, Any]] = None,
          arch: Optional[ArchConfig] = None
          ) -> Tuple[Dict[str, Any], ContinuousBatcher]:
    """Run the requests to completion. ``params`` (the model's tree on
    ``args.device``) replaces the seeded fp32 init when given; ``arch``
    (e.g. a depth-cut config) replaces ``get_arch(args.arch)``. Returns
    the statistics printed by ``main`` and the batcher (its final
    cache)."""
    if arch is None:
        arch = get_arch(args.arch)
    if args.reduced:
        arch = make_reduced(arch)
    model = LMModel(arch, device=args.device)
    if params is None:
        params = model.init_params(args.seed, torch.float32)
    batcher = ContinuousBatcher(
        model, params, wave_slots=args.wave_slots, max_len=args.max_len,
        page_tokens=args.page_tokens, n_pages=args.n_pages,
        allocator=AllocatorKind(args.allocator))
    rng = np.random.RandomState(args.seed)
    for i in range(args.requests):
        batcher.submit(Request(req_id=i,
                               prompt_len=int(rng.randint(4, 32)),
                               max_new_tokens=args.max_new))
    stats = batcher.run(max_steps=5000)
    out = dataclasses.asdict(stats)
    out["allocator"] = args.allocator
    out["page_tokens"] = args.page_tokens
    out["allocator_contentions"] = batcher.kv.allocator_stats.contentions
    return out, batcher


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    out, _ = serve(parse_args(argv))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
