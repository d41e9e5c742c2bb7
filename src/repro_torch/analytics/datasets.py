"""Synthetic datasets from the paper (Section 4.2), scaled by a factor:
the port's copy of ``repro.analytics.datasets``.

Paper defaults: 100M records, group-by cardinality 1M for aggregations;
join tables 16M (build) : 256M (probe), the Blanas'11 decision-support
ratio. The generators are the reference's numpy code, call for call, so
their arrays equal the reference's bit for bit under a seed;
``to_tensors`` carries a dataset onto a device for W1-W3.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.core.config import resolve_device

PAPER_N_RECORDS = 100_000_000
PAPER_CARDINALITY = 1_000_000
PAPER_BUILD = 16_000_000
PAPER_PROBE = 256_000_000


@dataclass(frozen=True)
class AggDataset:
    keys: np.ndarray    # (N,) int32 group keys in [0, cardinality)
    vals: np.ndarray    # (N,) float32 measures
    cardinality: int
    name: str


def moving_cluster(n: int, cardinality: int, *, window_frac: float = 0.1,
                   seed: int = 0) -> AggDataset:
    """Keys drawn from a window that slides across the key space (streaming/
    spatial locality pattern)."""
    rng = np.random.RandomState(seed)
    w = max(1, int(cardinality * window_frac))
    offset = (np.arange(n, dtype=np.int64) * max(1, cardinality - w)) // max(1, n - 1)
    keys = (offset + rng.randint(0, w, n)) % cardinality
    return AggDataset(keys.astype(np.int32), rng.rand(n).astype(np.float32),
                      cardinality, "moving_cluster")


def sequential(n: int, cardinality: int, *, seed: int = 0) -> AggDataset:
    """Equal-length runs of incrementally increasing keys (transactional)."""
    rng = np.random.RandomState(seed)
    keys = (np.arange(n, dtype=np.int64) * cardinality // n).astype(np.int32)
    return AggDataset(keys, rng.rand(n).astype(np.float32), cardinality,
                      "sequential")


def zipf(n: int, cardinality: int, *, exponent: float = 0.5,
         seed: int = 0) -> AggDataset:
    """Zipf(e)-distributed keys via inverse-CDF sampling (paper: e = 0.5)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, cardinality + 1, dtype=np.float64)
    probs = ranks ** -exponent
    cdf = np.cumsum(probs)
    cdf /= cdf[-1]
    u = rng.rand(n)
    keys = np.searchsorted(cdf, u).astype(np.int32)
    # randomize which key ids are the heavy ones
    perm = rng.permutation(cardinality).astype(np.int32)
    return AggDataset(perm[keys], rng.rand(n).astype(np.float32),
                      cardinality, "zipf")


def heavy_hitter(n: int, cardinality: int, *, heavy_frac: float = 0.25,
                 seed: int = 0) -> AggDataset:
    """One key receives ``heavy_frac`` of all records; rest uniform."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, cardinality, n).astype(np.int32)
    heavy = rng.rand(n) < heavy_frac
    keys[heavy] = rng.randint(0, cardinality)
    return AggDataset(keys, rng.rand(n).astype(np.float32), cardinality,
                      "heavy_hitter")


AGG_DATASETS = {
    "moving_cluster": moving_cluster,
    "sequential": sequential,
    "zipf": zipf,
    "heavy_hitter": heavy_hitter,
}


@dataclass(frozen=True)
class JoinDataset:
    build_keys: np.ndarray   # (R,) unique int32
    build_vals: np.ndarray   # (R,) float32
    probe_keys: np.ndarray   # (S,) int32, drawn from build keys (FK)
    probe_vals: np.ndarray   # (S,) float32
    name: str


def blanas_join(n_build: int, n_probe: int, *, seed: int = 0) -> JoinDataset:
    """PK-FK join tables at the paper's 1:16 ratio (Blanas'11)."""
    rng = np.random.RandomState(seed)
    build_keys = rng.permutation(n_build * 4)[:n_build].astype(np.int32)
    probe_keys = build_keys[rng.randint(0, n_build, n_probe)]
    return JoinDataset(build_keys, rng.rand(n_build).astype(np.float32),
                       probe_keys, rng.rand(n_probe).astype(np.float32),
                       "blanas_1_16")


def to_tensors(ds: Union[AggDataset, JoinDataset],
               device: Union[None, str, torch.device] = None
               ) -> Dict[str, torch.Tensor]:
    """The dataset's arrays as tensors on ``device`` (the CUDA device unless
    the caller names another; raises without one): {"keys", "vals"} for an
    AggDataset, {"build_keys", "build_vals", "probe_keys", "probe_vals"}
    for a JoinDataset."""
    dev = resolve_device(device)
    return {f.name: torch.from_numpy(getattr(ds, f.name)).to(dev)
            for f in dataclasses.fields(ds)
            if isinstance(getattr(ds, f.name), np.ndarray)}
