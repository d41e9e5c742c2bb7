"""The paper's W1-W4 inputs (Section 4.2), drawn on the device from a seed.

Aggregation (W1, W2): ``n`` records of (int32 group key, float32 value in
[0, 1)) over ``groups`` keys, the keys Zipf(exponent) by inverse CDF over
ranks 1..groups, the ranks mapped to key ids by a random permutation
(the mix's ``keys``: ``{"kind": "zipf", "exponent": e}``).

Join (W3, W4): Blanas'11 PK-FK tables; ``build`` unique int32 keys drawn
without replacement from [0, key_space) with float32 values in [0, 1),
and ``probe`` foreign keys drawn uniformly from the build keys.

All draws use one ``torch.Generator`` on ``device``: the same seed gives
the same inputs, and every seed the same sizes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from bench.datagen.tpch import generator

I32, F32, F64 = torch.int32, torch.float32, torch.float64


def agg_keys(n: int, groups: int, dist: Mapping, g: torch.Generator,
             device: torch.device) -> torch.Tensor:
    if dist.get("kind") != "zipf":
        raise ValueError(f"unknown key distribution {dist.get('kind')!r}")
    ranks = torch.arange(1, groups + 1, dtype=F64, device=device)
    cdf = torch.cumsum(ranks ** -float(dist["exponent"]), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=g, device=device, dtype=F64)
    idx = torch.clamp(torch.searchsorted(cdf, u), max=groups - 1)
    del u
    perm = torch.randperm(groups, generator=g, device=device).to(I32)
    return perm[idx]


def agg_inputs(n: int, groups: int, dist: Mapping, seed: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    g = generator(seed, device)
    keys = agg_keys(n, groups, dist, g, device)
    vals = torch.rand(n, generator=g, device=device, dtype=F32)
    return {"keys": keys, "vals": vals}


def join_inputs(build: int, probe: int, key_space: int, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    g = generator(seed + 1, device)
    build_keys = torch.randperm(key_space, generator=g, device=device,
                                dtype=I32)[:build].clone()
    build_vals = torch.rand(build, generator=g, device=device, dtype=F32)
    pick = torch.randint(0, build, (probe,), generator=g, device=device)
    return {"build_keys": build_keys, "build_vals": build_vals,
            "probe_keys": build_keys[pick]}


def make_inputs(sizes: Mapping, needs: set, dist: Mapping, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The aggregation and/or join inputs that the jobs in ``needs``
    ({"agg", "join"}) read."""
    out: Dict[str, torch.Tensor] = {}
    if "agg" in needs:
        a = sizes["agg"]
        out.update(agg_inputs(int(a["records"]), int(a["groups"]), dist,
                              seed, device))
    if "join" in needs:
        j = sizes["join"]
        out.update(join_inputs(int(j["build"]), int(j["probe"]),
                               int(j["key_space"]), seed, device))
    return out
