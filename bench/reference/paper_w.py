"""Plain PyTorch reference of W1-W4, worked out again from the inputs the
program was handed, in float64 (or, for the control, in a lower
precision). It imports nothing of the program.

  W1  per-group median (mean of the two middle values, NaN for an empty
      group): one sort by (key, value) through a 64-bit composite key
  W2  per-group record count
  W3, W4  the PK-FK join's match count and the sum of the matched build
      values, by binary search over the sorted build keys

Answers come in the program's output format ({name: numpy array}).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from bench.reference.tpch import acc_dtype, host

F64 = torch.float64


def medians(keys: torch.Tensor, vals: torch.Tensor, groups: int,
            dtype: torch.dtype) -> np.ndarray:
    """Per-group medians of ``vals`` (float32 in [0, 1), whose bit
    patterns order as their values) by group ``keys``."""
    composite = (keys.to(torch.int64) << 32) | vals.view(torch.int32).to(
        torch.int64)
    order = torch.sort(composite).values
    sv = (order & 0xFFFFFFFF).to(torch.int32).view(torch.float32).to(dtype)
    del order
    counts = torch.bincount(keys.to(torch.int64), minlength=groups)
    starts = torch.cumsum(counts, 0) - counts
    last = sv.shape[0] - 1
    lo = torch.clamp(starts + torch.clamp((counts - 1) // 2, min=0), 0, last)
    hi = torch.clamp(starts + counts // 2, 0, last)
    med = (sv[lo] + sv[hi]) / 2
    return host(torch.where(counts > 0, med.to(F64), float("nan")))


def counts(keys: torch.Tensor, groups: int, dtype: torch.dtype
           ) -> np.ndarray:
    c = torch.bincount(keys.to(torch.int64), minlength=groups)
    return host(c.to(dtype).to(F64))


def join(build_keys: torch.Tensor, build_vals: torch.Tensor,
         probe_keys: torch.Tensor, dtype: torch.dtype) -> Dict[str, np.ndarray]:
    sk, order = torch.sort(build_keys)
    sv = build_vals[order].to(dtype)
    pos = torch.clamp(torch.searchsorted(sk, probe_keys), 0,
                      sk.shape[0] - 1)
    found = sk[pos] == probe_keys
    total = torch.where(found, sv[pos], 0).to(acc_dtype(dtype)).sum()
    return {"count": np.array(int(found.sum()), dtype=np.int64),
            "checksum": np.array(float(total.to(dtype)), dtype=np.float64)}


def answer(job_kind: str, inputs: Mapping[str, torch.Tensor], groups: int,
           dtype: torch.dtype = F64) -> Dict[str, np.ndarray]:
    """The reference's answer to one kind of job ("median", "count" or
    "join"), in the program's output format."""
    if job_kind == "median":
        vals = inputs["vals"]
        if dtype != F64:
            vals = vals.to(dtype).to(torch.float32)
        return {"medians": medians(inputs["keys"], vals, groups, dtype)}
    if job_kind == "count":
        return {"counts": counts(inputs["keys"], groups, dtype),
                "overflow": np.array(0, dtype=np.int32)}
    if job_kind == "join":
        return join(inputs["build_keys"], inputs["build_vals"],
                    inputs["probe_keys"], dtype)
    raise ValueError(f"unknown job kind {job_kind!r}")
