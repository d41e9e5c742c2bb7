#!/usr/bin/env python3
"""Time the block_histograms CUDA kernel and its launch floor at the
distributed path's route shape.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 scripts/tune_block_histograms.py [--sources "old=path/to/old.cu"]
        [--diag "name=path/to/diagnostic.cu"]

Compiles ``src/repro_torch/kernels/csrc/radix_partition.cu`` three times
into ``build/hist_variants/`` (gitignored), with the kernels' own nvcc
flags, all at once: as committed, with ``-DBH_NO_WORK`` (the same grid,
writing zeros without reading a key: the launch floor) and with
``-DBH_LOAD_ONLY`` (the keys read and summed, not counted: the floor of a
kernel of this grid that reads them); each extra ``name=path`` source
with the committed C interface (an earlier version, say), held to the
plain version like the committed build; and each ``--diag`` source, timed
only. Keys are made on the card from seed 0, shaped as the route call
that ``chip_smoke.py`` captures (one shard's q3 lineitem owners at SF1 on
8 shards: 750,080 keys in 0-7, 3% of them the -1 padding, 8 bins, block
256), and at 256 bins (the shared-memory path). Each build is timed by
device time under torch.profiler over 50 launches, in turns (A B ... B A),
with CUDA events beside it (those read the host's issue rate for a call
this small); every build that claims to be right must give
``block_histograms_ref``'s counts. Prints the card's name and power limit,
then one JSON line per build and shape: times, the bound, ptxas's
registers and spills, and the SM clock and power under load. Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import _tune

N = 750_080
SHAPES = {"q3 route, 8 bins": (8, 0, 256), "256 bins": (256, 0, 256)}
VARIANTS = {"committed": [], "no_work": ["-DBH_NO_WORK"],
            "load_only": ["-DBH_LOAD_ONLY"]}
REPS = 50
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", default="",
                    help="space-separated name=path of extra kernel sources")
    ap.add_argument("--diag", default="",
                    help="space-separated name=path of sources timed only")
    args = ap.parse_args()
    import torch
    dev = _tune.cuda_device("tune_block_histograms")
    if dev is None:
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.radix_partition.ref import block_histograms_ref

    print(f"card: {_tune.card_line()}", flush=True)
    src = str(build.CSRC / build.SOURCES["radix_partition"])
    builds = {name: (src, flags) for name, flags in VARIANTS.items()}
    extra = dict(item.split("=", 1) for item in args.sources.split())
    diag = dict(item.split("=", 1) for item in args.diag.split())
    builds.update({name: (path, []) for name, path in extra.items()})
    builds.update({name: (path, []) for name, path in diag.items()})
    unchecked = {"no_work", "load_only", *diag}
    libs = _tune.compile_all(builds, "hist_variants", "hist")

    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, 8, (N,), device=dev, dtype=torch.int32,
                         generator=gen)
    keys[torch.rand(N, device=dev, generator=gen) < 0.03] = -1
    stream = torch.cuda.current_stream().cuda_stream
    fns = {name: _tune.bind(path, "block_histograms_launch", ARGTYPES)
           for name, (path, _) in libs.items()}
    for shape, (n_bins, shift, block) in SHAPES.items():
        n_blocks = N // block
        out = torch.empty((n_blocks, n_bins), dtype=torch.int32, device=dev)
        want = block_histograms_ref(keys, n_bins=n_bins, shift=shift,
                                    block=block)
        runs = {}
        for name, fn in fns.items():
            def run(fn=fn, name=name):
                rc = fn(keys.data_ptr(), out.data_ptr(), n_blocks, block,
                        n_bins, shift, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            runs[name] = run
            if name in unchecked:
                continue
            out.fill_(-1)
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} at {shape}: differs from "
                                     "the plain version")
        device = _tune.in_turns(runs, _tune.device_ms, REPS)
        events = _tune.in_turns(runs, _tune.cuda_ms, REPS)
        moved = 4 * N + 4 * n_blocks * n_bins
        bound = moved / 3.35e12 * 1e3
        for name, run in runs.items():
            clock = _tune.clock_under_load(run, min(events[name]))
            print(json.dumps({"build": name, "shape": shape,
                              "keys": N, "n_bins": n_bins, "block": block,
                              "device_ms": device[name], "ms": events[name],
                              "bound_ms": bound,
                              "checked": name not in unchecked,
                              "ptxas": libs[name][1],
                              "sm_clock_max_power_under_load": clock}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
