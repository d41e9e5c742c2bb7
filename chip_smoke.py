#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main path gives it, drives the port's main path (all seven TPC-H queries
at SF1 through ``repro_torch.analytics.tpch.run_query``) under the
kernel, plain and cost-based contexts, checks the answers against each
other and against a float64 evaluation, shows that the main path launched
every kernel, and prints the kernels' times beside their bounds. Any
failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. It imports nothing of JAX and nothing of the JAX package.

The last lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE, SEED = 1.0, 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
WARM_REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events around the whole run, after ``warmup`` untimed calls)."""
    import torch
    for _ in range(warmup):
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


def bound_ms(n_bytes: float, n_ops: float):
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def capture(module, name: str, store: list):
    """Record the arguments of every call to ``module.name``."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        store.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_hash_aggregate(ids, vals, n_bins, label):
    """Kernel vs plain version; kernel bit-equal across two runs. The
    tolerance per (p, bin, c) is 1e-4 times the sum of |vals| in that bin:
    both sides are f32 sums of the same terms in different orders, whose
    difference is a few units of 2^-24 times that sum per term added."""
    import torch
    from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
    from repro_torch.kernels.hash_aggregate.ref import \
        hash_aggregate_multi_ref
    a = hash_aggregate_multi(ids, vals, n_bins=n_bins, mode="cuda")
    b = hash_aggregate_multi(ids, vals, n_bins=n_bins, mode="cuda")
    plain = hash_aggregate_multi_ref(ids, vals, n_bins=n_bins)
    scale = hash_aggregate_multi_ref(ids, vals.abs(), n_bins=n_bins)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"hash_aggregate {label}: two runs differ")
    err = (a - plain).abs()
    bad = err > 1e-4 * scale + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"hash_aggregate {label}: {int(bad.sum())} "
                             f"sums off, max err {float(err.max())}")
    log(f"hash_aggregate {label}: shape {tuple(ids.shape)} C={vals.shape[2]}"
        f" bins={n_bins} max_abs_err={float(err.max())} bit-equal runs")
    return float(err.max())


def check_join_probe(bk, bv, pk, label):
    """Kernel vs plain version: vals and found must be equal."""
    import torch
    from repro_torch.kernels.join_probe import join_probe
    from repro_torch.kernels.join_probe.ref import join_probe_ref
    v, f = join_probe(bk, bv, pk, mode="cuda")
    rv, rf = join_probe_ref(bk, bv, pk)
    torch.cuda.synchronize()
    if not (torch.equal(v, rv) and torch.equal(f, rf)):
        raise AssertionError(f"join_probe {label}: differs from the plain "
                             f"version ({int((v != rv).sum())} vals, "
                             f"{int((f != rf).sum())} found)")
    log(f"join_probe {label}: P={pk.shape[0]} Bk={bk.shape[1]} "
        f"Pk={pk.shape[1]} equal ({int(f.sum())} found)")
    return float((v - rv).abs().max()) if v.numel() else 0.0


def synthetic_probe(P, Bk, Pk, gen, dev):
    import torch
    bk = torch.stack([torch.randperm(3 * Bk, device=dev, generator=gen)[:Bk]
                      for _ in range(P)]).to(torch.int32)
    bk[:, Bk - Bk // 5:] = -1                             # build padding
    bv = (torch.arange(P * Bk, device=dev, dtype=torch.float32)
          .reshape(P, Bk) % (1 << 23))
    bv[bk < 0] = 0.0
    pk = torch.randint(0, 3 * Bk, (P, Pk), device=dev, dtype=torch.int32,
                       generator=gen)                      # many misses
    pk[:, ::7] = -1                                       # probe padding
    return bk, bv, pk


def kernel_phase(data, dev):
    """Capture the main path's kernel inputs at SF1, hold each kernel
    against its plain version there and on edge cases, and time both."""
    import torch
    from repro_torch.analytics import columnar, planner
    from repro_torch.analytics.tpch import run_query

    forced = planner.ExecutionContext(executor="kernel", join="kernel")
    aggs, probes = {}, []
    for name in ("q1", "q18", "q3"):
        store = []
        with capture(columnar, "hash_aggregate_multi", store), \
                capture(columnar, "join_probe", probes):
            run_query(name, data, context=forced)
        if store:
            aggs[name] = store[0]
    torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    agg_errs = {name: check_hash_aggregate(args[0], args[1], kw["n_bins"],
                                           f"{name} main-path inputs")
                for name, (args, kw) in aggs.items()}
    for P, T, C, nb, label in [(3, 10_000, 1, 200, "C=1, ids out of range"),
                               (1, 50_000, 6, 10_000, "one partition, "
                                "3 bin tiles, ids out of range"),
                               (5, 777, 4, 64, "ragged rows")]:
        ids = torch.randint(-7, nb + 7, (P, T), device=dev,
                            dtype=torch.int32, generator=gen)
        vals = torch.randn((P, T, C), device=dev, generator=gen)
        check_hash_aggregate(ids, vals, nb, label)

    big = max(probes, key=lambda c: c[0][2].numel() * c[0][0].shape[1])
    bk, bv, pk = big[0]
    probe_err = check_join_probe(bk, bv, pk, "q3 main-path inputs (SF1)")
    for P, Bk, Pk, label in [(64, 2432, 9472, "SF 0.05 shape"),
                             (4, 300, 1001, "Pk not a multiple of the block"),
                             (3, 9000, 700, "Bk over two shared tiles")]:
        check_join_probe(*synthetic_probe(P, Bk, Pk, gen, dev), label)
    return aggs, agg_errs, big, probe_err


def time_hash_aggregate(args, kw, label):
    import torch
    from repro_torch.kernels.hash_aggregate import hash_aggregate_multi
    from repro_torch.kernels.hash_aggregate.ref import \
        hash_aggregate_multi_ref
    ids, vals = args[0], args[1]
    n_bins = kw["n_bins"]
    P, T = ids.shape
    C = vals.shape[2]
    ms = cuda_ms(lambda: hash_aggregate_multi(ids, vals, n_bins=n_bins,
                                              mode="cuda"), reps=20)
    plain = cuda_ms(lambda: hash_aggregate_multi_ref(ids, vals,
                                                     n_bins=n_bins), reps=5)
    # one library call for the same sums: index_add_ over p * n_bins + id
    # (every id of these inputs is in range; the flat index is input layout)
    flat = (ids.to(torch.int64) + n_bins * torch.arange(
        P, device=ids.device)[:, None]).reshape(-1)
    v2 = vals.reshape(P * T, C)
    lib = cuda_ms(lambda: torch.zeros((P * n_bins, C), device=ids.device)
                  .index_add_(0, flat, v2), reps=5)
    n_bytes = 4 * (P * T + P * T * C + P * n_bins * C)
    b_ms, b_by = bound_ms(n_bytes, P * T * C)
    return dict(shape=f"{label}: ids ({P}, {T}) int32, vals ({P}, {T}, {C}) "
                f"f32, n_bins {n_bins}", ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def time_join_probe(args, label):
    from repro_torch.kernels.join_probe import join_probe
    from repro_torch.kernels.join_probe.ref import join_probe_ref
    bk, bv, pk = args
    P, Bk = bk.shape
    Pk = pk.shape[1]
    ms = cuda_ms(lambda: join_probe(bk, bv, pk, mode="cuda"), reps=5)
    plain = cuda_ms(lambda: join_probe_ref(bk, bv, pk), reps=1)
    n_bytes = 8 * P * Bk + 4 * P * Pk + 5 * P * Pk
    # The function's own work: build keys are unique apart from the -1
    # padding, so a hashed or sorted probe inside each partition gives the
    # same answer with one insert per build slot and one lookup per probe
    # slot. The nested loop of join_probe.cu compares every (probe, build)
    # pair instead; that count is reported apart, as the design's floor.
    b_ms, b_by = bound_ms(n_bytes, float(P * (Bk + Pk)))
    design_ms = P * Pk * Bk / F32_OPS_PER_S * 1e3
    return dict(shape=f"{label}: build ({P}, {Bk}), probe ({P}, {Pk})",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, design_floor_ms=design_ms)


# ---------------------------------------------------------------------------
# phase 4: the main path at SF1
# ---------------------------------------------------------------------------
def oracle_f64(tables):
    """The seven queries' sums in float64, computed directly from the
    columns (independent of the planner and the operators)."""
    import torch
    from repro_torch.analytics.tpch import DATE1
    f64 = torch.float64
    li, od, cu = tables["lineitem"], tables["orders"], tables["customer"]
    na, su = tables["nation"], tables["supplier"]
    price, disc = li["l_extendedprice"].to(f64), li["l_discount"].to(f64)
    qty, tax = li["l_quantity"].to(f64), li["l_tax"].to(f64)

    def seg(x, ids, n):
        return torch.zeros(n, dtype=f64, device=x.device).index_add_(
            0, ids.to(torch.int64), x)

    out = {}
    m = (li["l_shipdate"] <= DATE1 - 90).to(f64)
    g = li["l_returnflag"] * 2 + li["l_linestatus"]
    cnt = seg(m, g, 6)
    dp = price * (1 - disc)
    out["q1"] = dict(sum_qty=seg(qty * m, g, 6),
                     sum_base_price=seg(price * m, g, 6),
                     sum_disc_price=seg(dp * m, g, 6),
                     sum_charge=seg(dp * (1 + tax) * m, g, 6),
                     avg_qty=seg(qty * m, g, 6) / cnt.clamp(min=1),
                     avg_price=seg(price * m, g, 6) / cnt.clamp(min=1),
                     count_order=cnt, _count=cnt)
    rf = li["l_returnflag"]
    c3 = seg(m, rf, 3)
    out["qm"] = dict(avg_qty=seg(qty * m, rf, 3) / c3.clamp(min=1),
                     count_order=c3, _count=c3)
    out["qq"] = dict(count_order=c3, _count=c3)
    date = DATE1 // 2
    cust_ok = cu["c_mktsegment"] == 1
    ord_ok = (od["o_orderdate"] < date) & cust_ok[od["o_custkey"].long()]
    li_ok = (li["l_shipdate"] > date) & ord_ok[li["l_orderkey"].long()]
    out["q3"] = dict(revenue=seg(dp * li_ok, li["l_orderkey"],
                                 od["o_orderkey"].shape[0]))
    nat_ok = na["n_regionkey"] == 2
    cust5 = nat_ok[cu["c_nationkey"].long()]
    ord5 = ((od["o_orderdate"] >= 0) & (od["o_orderdate"] < 365)
            & cust5[od["o_custkey"].long()])
    c_nat = cu["c_nationkey"][od["o_custkey"].long()][li["l_orderkey"].long()]
    s_nat = su["s_nationkey"][li["l_suppkey"].long()]
    w5 = (ord5[li["l_orderkey"].long()] & (c_nat == s_nat)).to(f64)
    out["q5"] = dict(revenue=seg(dp * w5, s_nat, 25),
                     _count=seg(w5, s_nat, 25))
    sd = li["l_shipdate"]
    w6 = ((sd >= 0) & (sd < 365) & ((li["l_discount"] - 0.06).abs() <= 0.011)
          & (li["l_quantity"] < 24.0)).to(f64)
    out["q6"] = dict(revenue=(price * disc * w6).sum()[None])
    per_order = seg(qty, li["l_orderkey"], od["o_orderkey"].shape[0])
    big = (per_order > 212.0).to(f64)
    n_cust = cu["c_custkey"].shape[0]
    out["q18"] = dict(qty=seg(per_order * big, od["o_custkey"], n_cust),
                      _count=seg(big, od["o_custkey"], n_cust))
    return out


CONTEXTS = {
    "kernel": dict(executor="kernel", join="kernel"),   # both kernels forced
    "plain": dict(executor="xla", join="sorted"),       # no kernel
    "cost": dict(executor="cost"),                      # the default
}
# Every float output is a sum in f32 (or a ratio of one), read against the
# float64 evaluation as |got - want| / max(|want|, 1) and held to its
# context's limit, set from the largest readings of sound runs on the card
# (printed on the "sums:" line; PERF.md has them). The plain path adds up
# to 3M rows into one f32 address with float atomics: its error is a bias
# of the rounding, read at 5.1e-4 (qm's avg_qty, integer quantities whose
# running sum passes 2^26), so it and the cost context, which runs that
# path for qm and qq, are held to 1e-3. The kernel context sums rows in
# short chunks and adds the chunk partials in order; it is held to 1e-5,
# which still fails a fused path that loses 15 of q1's 1.5M rows per group.
SUM_RTOL = {"kernel": 1e-5, "plain": 1e-3, "cost": 1e-3}
EXACT_KEYS = ("o_orderkey", "count_order", "_count", "_overflow", "med_qty",
              "med_price", "p90_price", "p25_qty")


def rel_dev(got, want) -> float:
    """Largest |got - want| / max(|want|, 1) over the entries."""
    import numpy as np
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def check_results(results, oracle):
    """Integers, counts and order statistics must equal the plain path's;
    every float output is read against the float64 evaluation, and each
    context's largest relative deviation is held to its SUM_RTOL."""
    import numpy as np
    import torch
    worst = {ctx: (0.0, "") for ctx in results}

    def note(ctx, r, label):
        if r > worst[ctx][0]:
            worst[ctx] = (r, label)

    for name in results["plain"]:
        ref = {k: v.cpu() for k, v in results["plain"][name].items()}
        for ctx, res in results.items():
            got = {k: v.cpu() for k, v in res[name].items()}
            if set(got) != set(ref):
                raise AssertionError(f"{name}/{ctx}: keys {sorted(got)}")
            for k, v in got.items():
                if v.shape != ref[k].shape:
                    raise AssertionError(f"{name}/{ctx}/{k}: shape {v.shape}")
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"{name}/{ctx}/{k}: not finite")
                if k in EXACT_KEYS or not v.is_floating_point():
                    if not torch.equal(v, ref[k]):
                        raise AssertionError(f"{name}/{ctx}/{k}: differs "
                                             "from the plain path")
                elif k not in oracle.get(name, {}):
                    raise AssertionError(f"{name}/{k}: no float64 evaluation")
            if int(got.get("_overflow", torch.zeros(()))) != 0:
                raise AssertionError(f"{name}/{ctx}: overflow")
            for k, want in oracle.get(name, {}).items():
                want = want.cpu().numpy()
                g = got[k].to(torch.float64).numpy()
                if name == "q3":
                    # the top-10 revenues against the float64 revenue of the
                    # orders chosen, and against the float64 top 10
                    keys = got["o_orderkey"].long().numpy()
                    note(ctx, rel_dev(g, want[keys]),
                         f"q3/{ctx}/{k} of the chosen orders")
                    want = np.sort(want)[::-1][:10]
                note(ctx, rel_dev(g, want), f"{name}/{ctx}/{k}")
    log("sums: largest relative deviation from float64 " + ", ".join(
        f"[{ctx}] {r!r} ({label})" for ctx, (r, label) in worst.items()))
    for ctx, (r, label) in worst.items():
        if r > SUM_RTOL[ctx]:
            raise AssertionError(f"{label}: off float64 by {r!r} relative, "
                                 f"over {SUM_RTOL[ctx]}")
    log("results: kernel and cost contexts give the plain path's integers; "
        f"sums agree with float64 within {SUM_RTOL}")


def main_path(data):
    import torch
    from repro_torch.analytics import planner
    from repro_torch.analytics.tpch import LOGICAL_QUERIES, run_query
    from repro_torch.kernels import common

    ctxs = {k: planner.ExecutionContext(**v) for k, v in CONTEXTS.items()}
    torch.cuda.synchronize()
    common.reset_launches()                 # just before the main path
    t0 = time.perf_counter()
    results = {c: {q: run_query(q, data, context=ctx)
                   for q in LOGICAL_QUERIES} for c, ctx in ctxs.items()}
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)        # just after it
    log(f"main path: 7 queries x {len(ctxs)} contexts in "
        f"{time.perf_counter() - t0:.3f} s (first runs), launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    warm = {c: {q: cuda_ms(lambda q=q, ctx=ctx: run_query(q, data,
                                                          context=ctx),
                           reps=WARM_REPS, warmup=0)
                for q in LOGICAL_QUERIES} for c, ctx in ctxs.items()}
    return results, launches, warm


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.analytics import tpch
        from repro_torch.kernels import build, common
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    if os.environ.get(common.ENV_VAR, "auto") not in ("auto", "cuda"):
        raise RuntimeError(f"{common.ENV_VAR} forces the plain versions; "
                           "unset it to test the kernels")
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    seconds = build.build()
    log(f"build: {seconds:.3f} s for {sorted(build.SOURCES)}")
    for name in build.SOURCES:
        log(build.log_path(name).read_text().strip())

    t0 = time.perf_counter()
    data = tpch.generate(scale=SCALE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rows = {t: next(iter(c.values())).shape[0] for t, c in data.tables.items()}
    log(f"data: SF{SCALE} seed {SEED} {rows} in "
        f"{time.perf_counter() - t0:.3f} s")

    aggs, agg_errs, probe, probe_err = kernel_phase(data, dev)
    agg_times = {q: dict(time_hash_aggregate(*aggs[q], f"{q} at SF1"),
                         max_abs_err=agg_errs[q]) for q in ("q1", "q18")}
    probe_time = time_join_probe(probe[0], "q3 lineitem x orders at SF1")
    for q, t in agg_times.items():
        log(f"hash_aggregate timing {json.dumps(t)}")
    log(f"join_probe timing {json.dumps(probe_time)}")

    results, launches, warm = main_path(data)
    check_results(results, oracle_f64(data.tables))
    for c, per_q in warm.items():
        log(f"warm ms per query [{c}]: {json.dumps(per_q)}")

    head = agg_times["q18"]
    kernels = [
        dict(name="hash_aggregate_multi", route="cuda",
             source="src/repro_torch/kernels/csrc/hash_aggregate.cu",
             replaces="src/repro/kernels/hash_aggregate/kernel.py:54",
             launches=launches["hash_aggregate_multi"], **head,
             other_shapes=[agg_times["q1"]]),
        dict(name="join_probe", route="cuda",
             source="src/repro_torch/kernels/csrc/join_probe.cu",
             replaces="src/repro/kernels/join_probe/kernel.py:40",
             launches=launches["join_probe"], max_abs_err=probe_err,
             **probe_time),
    ]
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:            # any failed phase: no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
