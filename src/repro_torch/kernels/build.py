"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. No
PyTorch header is included, so a build takes seconds. Libraries are named
by a digest of their source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. ``build()`` starts one ``nvcc`` for
every missing library at once and waits for all of them.

The build directory is ``build/repro_torch_kernels`` at the repository
root (``.gitignore`` lists ``build/``), or ``$REPRO_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"hash_aggregate": "hash_aggregate.cu",
           "join_probe": "join_probe.cu",
           "radix_partition": "radix_partition.cu",
           "radix_probe": "radix_probe.cu",
           "flash_attention": "flash_attention.cu",
           "rglru_scan": "rglru_scan.cu",
           "rwkv6_scan": "rwkv6_scan.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every named source whose library is missing, all in
    parallel. Returns the wall seconds spent; raises on a failed build."""
    with _LOCK:
        return _build_locked(list(names or SOURCES))


def _build_locked(names) -> float:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
