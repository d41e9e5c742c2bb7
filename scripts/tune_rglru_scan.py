#!/usr/bin/env python3
"""Time the rglru_scan CUDA kernel and its diagnostic build at the
recurrentgemma-2b prefill shape.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 scripts/tune_rglru_scan.py [--runs "16,32"]
        [--sources "old=path/to/old.cu"] [--source-chunk 64]

Compiles ``src/repro_torch/kernels/csrc/rglru_scan.cu`` twice into
``build/scan_variants/`` (gitignored), with the kernels' own nvcc flags,
all at once: as committed, and with ``-DRG_NO_WAIT`` (no wait on the
predecessor chunk; its results are wrong and not checked); and each extra
``name=path`` source with the committed C interface (an earlier version,
say), launched with ``--source-chunk`` as its L argument. The committed
build is launched at each run length of ``--runs`` (steps a warp covers
before a carry enters). At a, b (2, 4096, 2560) float32 made on the card
from seed 0 (a in [0.01, 0.99], b normal), every build is timed with CUDA
events over 20 launches and by device time under torch.profiler, in turns
(A B ... B A); every build that claims to be right is held within 1e-5 of
``linear_scan_sequential`` and must give the same bits on two runs, and
the committed one also the bits of ``tests/_scan_order.py``. Prints the
card's name and power limit, then one JSON line per build: its times,
error, ptxas's registers and spills, and the SM clock and power read by
nvidia-smi under load. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import _tune

B, S, D = 2, 4096, 2560
VARIANTS = {"committed": [], "no_wait": ["-DRG_NO_WAIT"]}
REPS = 20
TOL = 1e-5
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="",
                    help="comma-separated run lengths for the committed "
                         "build (default: the wrapper's CHUNK)")
    ap.add_argument("--sources", default="",
                    help="space-separated name=path of extra kernel sources")
    ap.add_argument("--source-chunk", type=int, default=64,
                    help="the L argument the extra sources are launched with")
    args = ap.parse_args()
    import torch
    dev = _tune.cuda_device("tune_rglru_scan")
    if dev is None:
        return 1
    sys.path.insert(0, os.path.join(_tune.ROOT, "tests"))
    from _scan_order import kernel_order_scan
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.ops import CHUNK
    from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential

    print(f"card: {_tune.card_line()}", flush=True)
    src = str(build.CSRC / build.SOURCES["rglru_scan"])
    builds = {name: (src, flags) for name, flags in VARIANTS.items()}
    extra = dict(item.split("=", 1) for item in args.sources.split())
    builds.update({name: (path, []) for name, path in extra.items()})
    libs = _tune.compile_all(builds, "scan_variants", "scan_")

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((B, S, D), device=dev, generator=gen) * 0.98 + 0.01
    b = torch.randn((B, S, D), device=dev, generator=gen)
    want = linear_scan_sequential(a, b)
    out = torch.empty_like(a)
    # scratch for any design of this interface: up to one word a step
    words = torch.empty(B * S * D + 1, dtype=torch.int64, device=dev)
    prod = torch.empty(B * S * D, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    runs_of = [int(r) for r in args.runs.split(",") if r] or [CHUNK]
    launches = {}                           # name: (library, L)
    for r in runs_of:
        launches[f"committed run {r}"] = ("committed", r)
    launches[f"no_wait run {runs_of[0]}"] = ("no_wait", runs_of[0])
    for name in extra:
        launches[name] = (name, args.source_chunk)

    runs = {}
    for name, (lib, L) in launches.items():
        fn = _tune.bind(libs[lib][0], "rglru_scan_launch", ARGTYPES)

        def run(fn=fn, name=name, L=L):
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    prod.data_ptr(), words.data_ptr(), B, S, D, L, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        runs[name] = run

    checks = {}
    for name, (lib, L) in launches.items():
        if lib == "no_wait":
            continue
        runs[name]()
        first = out.clone()
        runs[name]()
        torch.cuda.synchronize()
        err = (out - want).abs()
        if not bool((err <= TOL + TOL * want.abs()).all()):
            raise AssertionError(f"{name}: off the plain version by "
                                 f"{float(err.max())!r}, over {TOL}")
        if not torch.equal(first.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"{name}: two runs differ")
        check = {"max_abs_err": float(err.max()), "bits_two_runs": True}
        if lib == "committed":
            model = kernel_order_scan(a.cpu(), b.cpu(), L)
            check["bits_of_scan_order_model"] = torch.equal(
                out.cpu().view(torch.int32), model.view(torch.int32))
            if not check["bits_of_scan_order_model"]:
                raise AssertionError(f"{name}: not the order model's bits")
        checks[name] = check
    events = _tune.in_turns(runs, _tune.cuda_ms, REPS)
    device = _tune.in_turns(runs, _tune.device_ms, REPS)
    bound = 3 * 4 * a.numel() / 3.35e12 * 1e3
    print(f"bound: {bound!r} ms (bytes: a and b read, h written once)")
    for name, run in runs.items():
        clock = _tune.clock_under_load(run, min(events[name]))
        print(json.dumps({"build": name, "ms": events[name],
                          "device_ms": device[name],
                          **checks.get(name, {"checked": False}),
                          "ptxas": libs[launches[name][0]][1],
                          "sm_clock_max_power_under_load": clock}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
