#!/usr/bin/env python3
"""Time the hash_aggregate_multi CUDA kernel and its diagnostic builds at
the analytics path's three shapes.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 scripts/tune_hash_aggregate.py [--sources "old=path/to/old.cu"]

Compiles ``src/repro_torch/kernels/csrc/hash_aggregate.cu`` three times
into ``build/agg_variants/`` (gitignored), with the kernels' own nvcc
flags, all at once: as committed, with ``-DHA_NO_SUM`` (rows staged and
read, no group sums) and with ``-DHA_NO_TREE`` (peers found, no tree).
``--sources`` adds candidate or earlier versions with the committed
interface and launch plan, held to float64 like the committed build, and
``--diag`` diagnostic versions, timed only. Inputs are made on the card
from seed 0, shaped as the SF1 calls that ``chip_smoke.py`` captures: q18 (64
partitions of 187,648 rows, half of them padding, orders of 1-7 rows in
23,552 bins, C = 2; its rows in random order as at SF1, and in order), q1
(8 x 750,080 rows in 6 groups of 128 bins, 2% masked, C = 5) and one
shard's distributed call (8 x 281,600 rows in 3 groups, C = 2). Each
build is timed by device time under torch.profiler over 20 launches, in
turns (A B ... B A); the committed build and each of ``--sources`` are
held within 1e-5 of float64 sums (relative to the sums of |values|) and
must give the same bits on two runs. Prints the card's name and
power limit, then one JSON line per build and shape. Exits 1 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import _tune

VARIANTS = {"committed": [], "no_sum": ["-DHA_NO_SUM"],
            "no_tree": ["-DHA_NO_TREE"]}
REPS = 20
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12
ARGTYPES = ([ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_void_p])


def shapes(dev):
    """{name: (ids (P, T) int32, vals (P, T, C) f32, n_bins)} on ``dev``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)

    def price(shape):
        qty = torch.randint(1, 51, shape, device=dev, generator=gen).float()
        return qty, qty * (900 + 1200 * torch.rand(shape, device=dev,
                                                   generator=gen))
    # q18: orders of 1-7 rows in 23,552 bins, the second half padding; the
    # rows in random order (l_orderkey is uniform), and in order
    P, T, n_bins = 64, 187_648, 23_552
    lens = torch.randint(1, 8, (P, n_bins), device=dev, generator=gen)
    starts = torch.cumsum(lens, 1) - lens
    row = torch.arange(T // 2, device=dev).expand(P, -1).contiguous()
    bins = (torch.searchsorted(starts, row, right=True) - 1).to(torch.int32)
    shuffle = torch.argsort(torch.rand((P, T // 2), device=dev,
                                       generator=gen), dim=1)
    qty, px = price((P, T))
    vals = torch.stack([px, qty], dim=2)
    vals[:, T // 2:] = 0.0
    out = {}
    for name, b in (("q18", torch.gather(bins, 1, shuffle)),
                    ("q18 in order", bins)):
        ids = torch.zeros((P, T), dtype=torch.int32, device=dev)
        ids[:, :T // 2] = b
        out[name] = (ids, vals.contiguous(), n_bins)
    # q1: 6 groups, 2% of the rows masked to 0, C = 5
    P, T = 8, 750_080
    ids = torch.randint(0, 6, (P, T), device=dev, generator=gen,
                        dtype=torch.int32)
    qty, px = price((P, T))
    disc = torch.rand((P, T), device=dev, generator=gen) * 0.1
    vals = torch.stack([qty, px, px * (1 - disc), px * (1 - disc) * 1.05,
                        torch.ones_like(qty)], dim=2)
    vals[torch.rand((P, T), device=dev, generator=gen) < 0.02] = 0.0
    out["q1"] = (ids, vals.contiguous(), 128)
    # one shard's distributed call: 3 groups, C = 2
    P, T = 8, 281_600
    ids = torch.randint(0, 3, (P, T), device=dev, generator=gen,
                        dtype=torch.int32)
    qty, _ = price((P, T))
    out["distributed"] = (ids, torch.stack([qty, torch.ones_like(qty)],
                                           dim=2).contiguous(), 128)
    return out


def runner(path, ids, vals, n_bins, n_sms):
    """A function that launches the build at ``path`` once with the
    committed launch plan; returns it and the output tensor it writes."""
    import torch
    from repro_torch.kernels.hash_aggregate.ops import launch_plan
    P, T = ids.shape
    C = vals.shape[2]
    fn = _tune.bind(path, "hash_aggregate_multi_launch", ARGTYPES)
    tile_bins, n_chunks, rows, private = launch_plan(P, T, C, n_bins, n_sms)
    out = torch.empty((P, n_bins, C), device=ids.device)
    partial = torch.empty((P, n_chunks, n_bins, C), device=ids.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                partial.data_ptr(), P, T, C, n_bins, tile_bins, n_chunks,
                rows, int(private), stream)
        if rc != 0:
            raise RuntimeError(f"{path}: CUDA error {rc}")
    return run, out


def f64_sums(ids, vals, n_bins):
    import torch
    P, T, C = vals.shape
    flat = (ids.long() + n_bins * torch.arange(P, device=ids.device)[:, None])
    out = torch.zeros((P * n_bins, C), dtype=torch.float64,
                      device=ids.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1, C).double())
    return out.reshape(P, n_bins, C)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", default="",
                    help="space-separated name=path of candidate sources "
                         "with the committed interface")
    ap.add_argument("--diag", default="",
                    help="like --sources, but timed only (diagnostic builds "
                         "that give wrong sums)")
    args = ap.parse_args()
    import torch
    dev = _tune.cuda_device("tune_hash_aggregate")
    if dev is None:
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.hash_aggregate import hash_aggregate_multi

    print(f"card: {_tune.card_line()}", flush=True)
    src = str(build.CSRC / build.SOURCES["hash_aggregate"])
    builds = {name: (src, flags) for name, flags in VARIANTS.items()}
    extra = dict(item.split("=", 1) for item in args.sources.split())
    builds.update({name: (path, []) for name, path in extra.items()})
    builds.update({name: (path, []) for name, path in
                   (item.split("=", 1) for item in args.diag.split())})
    libs = _tune.compile_all(builds, "agg_variants")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, (ids, vals, n_bins) in shapes(dev).items():
        want = f64_sums(ids, vals, n_bins)
        scale = f64_sums(ids, vals.abs(), n_bins)
        runs = {name: runner(path, ids, vals, n_bins, n_sms)
                for name, (path, _) in libs.items()}
        runs["committed (wrapper)"] = (lambda: hash_aggregate_multi(
            ids, vals, n_bins=n_bins, mode="cuda"), None)
        errs = {}
        for name in ("committed", *extra):
            run, out = runs[name]
            run()
            first = out.clone()
            run()
            torch.cuda.synchronize()
            if not torch.equal(first, out):
                raise AssertionError(f"{shape} {name}: two runs differ")
            rel = ((out.double() - want).abs() / scale.clamp(min=1e-30))
            errs[name] = float(rel.max())
            if errs[name] > TOL:
                raise AssertionError(f"{shape} {name}: off float64 by "
                                     f"{errs[name]!r} of |values|")
        times = _tune.in_turns({name: run for name, (run, _) in runs.items()},
                               _tune.device_ms, REPS)
        P, T, C = vals.shape
        bound = 4 * (P * T * (1 + C) + P * n_bins * C) / HBM_BYTES_PER_S
        for name in runs:
            print(json.dumps({"shape": shape, "P_T_C_bins": [P, T, C, n_bins],
                              "build": name, "ms": times[name],
                              "bound_ms": bound * 1e3,
                              "rel_err": errs.get(name, "not checked"),
                              "ptxas": libs[name][1] if name in libs
                              else "as committed"}), flush=True)
        del runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
