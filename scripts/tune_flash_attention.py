#!/usr/bin/env python3
"""Time the flash_attention CUDA kernel and its diagnostic builds at the
recurrentgemma-2b prefill shape.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 scripts/tune_flash_attention.py [--sources "old=path/to/old.cu"]

Compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` three times
into ``build/fa_variants/`` (gitignored), with the kernels' own nvcc
flags, all at once: as committed, with ``-DFA_NO_LOADS`` (no K/V copies)
and with ``-DFA_NO_SOFTMAX`` (raw scores as probabilities); and each extra
``name=path`` source given (an earlier version of the kernel, say). At
q (2, 4096, 10, 256), k/v (2, 4096, 1, 256), window 2048, each build is
timed with CUDA events over 10 launches, in turns (A B ... B A), and
every build that claims to be right (the committed one and the extra
sources) is held within 1e-5 of ``attention_chunked``. Prints the card's
name and power limit, then one JSON line per build: its times, its error,
ptxas's registers and spills for the D = 256 kernel, and the SM clock and
power read by nvidia-smi under load. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import _tune

B, S, HQ, HKV, D, WINDOW = 2, 4096, 10, 1, 256, 2048
VARIANTS = {"committed": [], "no_loads": ["-DFA_NO_LOADS"],
            "no_softmax": ["-DFA_NO_SOFTMAX"]}
CHECKED = ("committed",)          # builds held to the plain version
REPS = 10
TOL = 1e-5
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", default="",
                    help="space-separated name=path of extra kernel sources")
    args = ap.parse_args()
    import torch
    dev = _tune.cuda_device("tune_flash_attention")
    if dev is None:
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_chunked

    print(f"card: {_tune.card_line()}", flush=True)
    src = str(build.CSRC / build.SOURCES["flash_attention"])
    builds = {name: (src, flags) for name, flags in VARIANTS.items()}
    extra = dict(item.split("=", 1) for item in args.sources.split())
    builds.update({name: (path, []) for name, path in extra.items()})
    libs = _tune.compile_all(builds, "fa_variants", f"fa_fwd_kernelILi{D}E")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, HQ, D), device=dev, generator=gen)
    k = torch.randn((B, S, HKV, D), device=dev, generator=gen)
    v = torch.randn((B, S, HKV, D), device=dev, generator=gen)
    scale = D ** -0.5
    want = attention_chunked(q, k, v, window=WINDOW, scale=scale)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for name, (path, _) in libs.items():
        fn = _tune.bind(path, "flash_attention_fwd_launch", ARGTYPES)

        def run(fn=fn, name=name):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, S, HQ, HKV, D, 0, 1, WINDOW, scale, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        runs[name] = run
    runs["committed (wrapper)"] = lambda: flash_attention(
        q, k, v, window=WINDOW, scale=scale, mode="cuda")

    errs = {}
    for name in list(CHECKED) + list(extra) + ["committed (wrapper)"]:
        out.fill_(float("nan"))
        got = runs[name]()
        torch.cuda.synchronize()
        got = out if got is None else got
        err = (got - want).abs()
        errs[name] = float(err.max())
        if not bool((err <= TOL + TOL * want.abs()).all()):
            raise AssertionError(f"{name}: off the plain version by "
                                 f"{errs[name]!r}, over {TOL}")
    times = _tune.in_turns(runs, _tune.cuda_ms, REPS)
    for name, run in runs.items():
        clock = _tune.clock_under_load(run, min(times[name]))
        usage = libs[name][1] if name in libs else "as committed"
        print(json.dumps({"build": name, "ms": times[name],
                          "max_abs_err": errs.get(name, "not checked"),
                          "ptxas": usage,
                          "sm_clock_max_power_under_load": clock}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
