#!/usr/bin/env python3
"""Time candidate tiles of the wkv6 CUDA kernel at the rwkv6-7b prefill shape.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 scripts/tune_wkv6_tiles.py [--tiles "4,4,32,8 8,2,32,4"]

A tile is (G key rows x C value columns a thread, JT value columns a
block, NB steps a batch) of head size 64. Each is compiled from a copy of
``src/repro_torch/kernels/csrc/rwkv6_scan.cu`` whose N = 64 tile is
replaced, into ``build/wkv6_tiles/`` (gitignored), with the kernels' own
nvcc flags, all at once. Each is held bit for bit against ``wkv6_ref`` at
(B, S, H, N) = (2, 4096, 64, 64) and timed with CUDA events over 20
launches, beside the committed kernel through its wrapper. Prints the
card's name and power limit, and one JSON line per tile: its time,
whether it is bit-equal, ptxas's registers and spills, and the SM clock
and power read by nvidia-smi while it runs. Exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

import _tune

SHAPE = (2, 4096, 64, 64)
TILE_LINE = "template <> struct Tile<64> : Cfg<64, {}, {}, {}, {}> {{}};"
REPS = 20
DEFAULT_TILES = "4,4,32,8 4,4,32,4 8,2,32,8 8,4,64,8 4,2,16,8 16,2,64,4"
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def compile_tiles(tiles):
    """Compile one library per tile, all at once; returns {tile: (path,
    ptxas line of the N = 64, 16-byte-copy kernel)}."""
    from repro_torch.kernels import build
    src = (build.CSRC / build.SOURCES["rwkv6_scan"]).read_text()
    committed = re.search(r"template <> struct Tile<64> : Cfg<64, [^>]*> "
                          r"\{\};", src)
    if committed is None:
        raise RuntimeError("rwkv6_scan.cu has no Tile<64> line to replace")
    out = os.path.join(_tune.ROOT, "build", "wkv6_tiles")
    os.makedirs(out, exist_ok=True)
    names = {tile: "tile_" + "_".join(map(str, tile)) for tile in tiles}
    builds = {}
    for tile, name in names.items():
        cu = os.path.join(out, name + ".cu")
        with open(cu, "w") as f:
            f.write(src.replace(committed.group(0), TILE_LINE.format(*tile)))
        builds[name] = (cu, [])
    libs = _tune.compile_all(builds, "wkv6_tiles", "wkv6_fwdILi64ELi4E")
    return {tile: libs[name] for tile, name in names.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default=DEFAULT_TILES,
                    help="space-separated G,C,JT,NB tiles")
    args = ap.parse_args()
    import torch
    dev = _tune.cuda_device("tune_wkv6_tiles")
    if dev is None:
        return 1
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    print(f"card: {_tune.card_line()}", flush=True)
    tiles = [tuple(int(x) for x in t.split(",")) for t in args.tiles.split()]
    libs = compile_tiles(tiles)

    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn(SHAPE, device=dev, generator=gen) * 0.5
               for _ in range(3))
    w = 0.6 + 0.39 * torch.rand(SHAPE, device=dev, generator=gen)
    u = torch.randn(SHAPE[2:], device=dev, generator=gen) * 0.5
    want_y, want_s = wkv6_ref(r, k, v, w, u)
    B, S, H, N = SHAPE
    y = torch.empty(SHAPE, device=dev)
    s_out = torch.empty((B, H, N, N), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    committed = _tune.cuda_ms(lambda: wkv6(r, k, v, w, u, mode="cuda"), REPS)
    print(json.dumps({"tile": "committed (wrapper)", "ms": committed}),
          flush=True)
    for tile, (path, usage) in libs.items():
        fn = _tune.bind(path, "wkv6_fwd_launch", ARGTYPES)

        def run():
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, S, H,
                    N, *r.stride()[:3], stream)
            if rc != 0:
                raise RuntimeError(f"tile {tile}: CUDA error {rc}")

        y.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        equal = torch.equal(y, want_y) and torch.equal(s_out, want_s)
        ms = _tune.cuda_ms(run, REPS)
        clock = _tune.clock_under_load(run, ms)
        rec = {"tile": dict(zip(("G", "C", "JT", "NB"), tile)), "ms": ms,
               "bit_equal": equal, "ptxas": usage,
               "sm_clock_max_power_under_load": clock}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
