"""What the kernel tuning scripts share: building variants of a kernel's
source, timing them on the card and reading the card's state.

Each ``scripts/tune_*.py`` keeps only its shapes and its check; run them
from the repository root on a machine with a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def cuda_device(script: str):
    """The first CUDA device, with ``src`` put on the path; None (and a
    note on stderr) without one."""
    import torch
    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device", file=sys.stderr)
        return None
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def sm_clock() -> str:
    """The SM clock, its maximum and the power drawn, read now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                           "clocks.max.sm,power.draw", "--format=csv,"
                           "noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def ptxas_usage(log: str, kernel: str | None = None) -> str:
    """ptxas -v's stack, spill and register lines: of the entry functions
    whose name holds ``kernel``, or of all of them."""
    lines = []
    for entry in log.split("Compiling entry function")[1:]:
        head, *body = entry.splitlines()
        if kernel is None or kernel in head:
            lines += [line.split(":", 1)[-1].strip() for line in body
                      if "bytes stack" in line or "Used" in line]
    return "; ".join(lines) or "not reported"


def compile_all(builds: dict, out_dir: str, kernel: str | None = None):
    """builds: {name: (source path, extra nvcc flags)}. One nvcc each with
    the kernels' own flags, all started together, into ``build/<out_dir>``
    (gitignored). Returns {name: (library path, ptxas line for
    ``kernel``)} and prints how long the builds took."""
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", out_dir)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, (src, flags) in builds.items():
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (lib, ptxas_usage(log, kernel))
    print(f"compiled {len(libs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return libs


def bind(path: str, entry: str, argtypes: list):
    """``entry`` of the library at ``path``, returning a C int."""
    fn = getattr(ctypes.CDLL(path), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of one call: CUDA events around ``reps`` calls, after one."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one call: the self time of its kernels, copies
    and memsets under torch.profiler over ``reps`` calls, after one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if not busy:
        raise RuntimeError("torch.profiler saw no device time")
    return busy / 1e3 / reps


def in_turns(runs: dict, timer, reps: int) -> dict:
    """Time every run of ``runs`` ({name: fn}) with ``timer`` in turns,
    A B ... B A, so that a drift of the clocks falls on all alike.
    Returns {name: [ms, ms]}."""
    order = list(runs)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(timer(runs[name], reps))
    return times


def clock_under_load(fn, ms: float) -> str:
    """``sm_clock`` read after about half a second of calls of ``fn``,
    each taking about ``ms``."""
    import torch
    for _ in range(max(1, int(500 / ms))):
        fn()
    clock = sm_clock()
    torch.cuda.synchronize()
    return clock
