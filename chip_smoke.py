#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main paths give it, and drives these paths through the port's entry
points:

  * the single-device path: all seven TPC-H queries at SF1 through
    ``repro_torch.analytics.tpch.run_query`` under the kernel, plain and
    cost-based contexts, checked against each other and against a float64
    evaluation;
  * the distributed path: the same queries at SF1 on a virtual mesh of 8
    shards under the four placement policies x {argsort, radix, cost}
    Exchange contexts and one composed kernel context, checked against the
    single-device plain path and float64 (argsort == radix and candidates
    TopK == replicated bit for bit), the largest ``hash_aggregate_multi``
    call of one shard timed, then W1/W2/W3 (``engine.dist_median`` /
    ``dist_count`` / ``dist_hash_join``) at the paper's sizes under each
    policy;
  * telemetry and tracing on those paths: the 7 queries at SF1 under the
    cost and kernel contexts on one device and the composed context on 8
    shards, recorded (``telemetry.recording()``) against unrecorded, the
    same bits, one registry execution per plan; ``explain_analyze`` of q3
    on 8 shards; the recording's cost per call; one traced compile and
    execute;
  * W1-W4 on one device at the same sizes, through the entry points of
    ``analytics/aggregate.py`` and ``analytics/join.py``
    (``count_direct``, ``count_partitioned``, ``median_jit``,
    ``hash_join``, ``index_join`` radix/sorted/hash), each against its
    oracle, with ``hash_aggregate_multi`` and ``join_probe`` timed at
    W2's and W3's shapes;
  * the LM serving path: recurrentgemma-2b at full width (26 layers,
    d_model 2560, 2.66B fp32 parameters drawn from a seeded generator on
    the card): one prefill of 2 x 4096 tokens through
    ``repro_torch.models.lm.LMModel.prefill`` (8 ``flash_attention`` and
    18 ``rglru_scan`` launches), its logits against the plain versions'
    prefill, 64 decode steps against the forward pass, and 32 requests
    served through ``repro_torch.launch.serve.serve``, the launcher's
    entry function;
  * the same for rwkv6-7b at full width (32 layers, d_model 4096, 64
    heads of 64, 7.58B fp32 parameters drawn on the card): one 2 x 4096
    prefill (32 ``wkv6`` launches, no other kernel), the kernel against
    its plain version at layer 0's inputs and on edge cases, logits
    against the plain prefill, 64 decode steps against the forward pass,
    and 32 requests served through the launcher.

The kernel launch counts are zeroed just before each path and read just
after it; a kernel of a path that never launched fails the run. It also
checks that the plain path's float sums are the same bits on every run,
and prints the kernels' times beside their bounds, warm ms per query and
peak memory per phase. Any failed phase exits non-zero. Without a CUDA
device it exits 1 and prints no result. It imports nothing of JAX and
nothing of the JAX package.

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


PROFILER_SESSIONS = 3


def device_sessions(fn, reps: int):
    """(device records, device microseconds, {CUDA kernel name:
    launches}) of one call of ``fn`` under torch.profiler, from
    ``PROFILER_SESSIONS`` sessions of ``reps`` calls each after one
    warm-up.

    On the card this runs on, a session now and then loses CUDA records
    of work that ran (all of them, or some of a kernel's) and now and
    then holds records of work that ran before it. ``fn`` runs the same
    work each call, so per record name the calls' launches are the median
    of the sessions' counts over ``reps``, rounded, and each launch takes
    the mean time of that name's records over all sessions. Sessions
    that disagree on their record counts are printed."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts, times, totals = {}, {}, []
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.key] = e.count
                times[e.key] = times.get(e.key, 0.0) + getattr(
                    e, "self_device_time_total", 0)
        for key in set(counts) | set(seen):
            counts.setdefault(key, []).append(seen.get(key, 0))
        totals.append(sum(seen.values()))
    if len(set(totals)) > 1:
        log(f"torch.profiler: {PROFILER_SESSIONS} sessions of {reps} "
            f"calls saw "
            f"{totals} device records")
    per_call = {k: round(statistics.median(
        c + [0] * (PROFILER_SESSIONS - len(c))) / reps) for k, c in counts.items()}
    per_call = {k: n for k, n in per_call.items() if n}
    if not per_call:
        raise RuntimeError("torch.profiler saw no device work")
    busy = sum(n * times[k] / sum(counts[k]) for k, n in per_call.items())
    return sum(per_call.values()), busy, per_call


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one call of ``fn``: the self time of
    every kernel, copy and memset it ran under torch.profiler, over
    ``reps`` calls after one warm-up (``device_sessions``). For a call
    that waits on the host (a flag read back), or that takes less device
    time than the host needs to issue it, where CUDA events around
    back-to-back calls would also count the host's gaps."""
    return device_sessions(fn, reps)[1] / 1e3


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``: a host clock around ``reps``
    back-to-back calls with no synchronize, after one warm-up. Where this
    exceeds the device time, the host's issue rate bounds the call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(n_bytes: float, n_ops: float):
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def capture(module, name: str, store: list, keep: int | None = None):
    """Record the arguments of every call to ``module.name`` (of the first
    ``keep`` calls when given)."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        if keep is None or len(store) < keep:
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
    """Kernel vs plain version: vals (bit for bit, so a -0.0 payload
    counts) and found must be equal."""
    import torch
    from repro_torch.kernels.join_probe import join_probe
    from repro_torch.kernels.join_probe.ref import join_probe_ref
    v, f = join_probe(bk, bv, pk, mode="cuda")
    rv, rf = join_probe_ref(bk, bv, pk)
    torch.cuda.synchronize()
    if not (torch.equal(v.view(torch.int32), rv.view(torch.int32))
            and torch.equal(f, rf)):
        raise AssertionError(f"join_probe {label}: differs from the plain "
                             f"version ({int((v != rv).sum())} vals, "
                             f"{int((f != rf).sum())} found)")
    log(f"join_probe {label}: P={pk.shape[0]} Bk={bk.shape[1]} "
        f"Pk={pk.shape[1]} bit-equal ({int(f.sum())} found)")
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


def colliding_probe(Bk, Pk, gen, dev):
    """One partition whose keys all start their walk at one table entry
    (their mixed hashes share the top bits): half the probes hit, half miss
    after walking the whole chain; a tenth are padding."""
    import torch
    from repro_torch.kernels.join_probe.ops import table_log2, unmix32
    b = table_log2(Bk)
    hashes = (7 << (32 - b)) + torch.arange(2 * Bk + 1, device=dev)
    keys = unmix32(hashes)
    keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys)
    keys = keys[keys != -1][:2 * Bk].to(torch.int32)
    bk = keys[:Bk][None].clone()
    bk[:, -Bk // 10:] = -1
    bv = torch.arange(Bk, device=dev, dtype=torch.float32)[None] - Bk // 2
    pk = keys[torch.randint(0, 2 * Bk, (1, Pk), device=dev,
                            generator=gen)]
    pk[:, ::10] = -1
    return bk, bv, pk


def join_probe_edges(gen, dev):
    """The kernel against its plain version off q3's shape, and duplicate
    build keys refused."""
    import torch
    from repro_torch.kernels.join_probe import join_probe
    for P, Bk, Pk, label in [(64, 2432, 9472, "SF 0.05 shape"),
                             (4, 300, 1001, "Pk not a multiple of the block"),
                             (3, 9000, 700, "Bk 9000, Pk 700")]:
        check_join_probe(*synthetic_probe(P, Bk, Pk, gen, dev), label)
    bk, bv, pk = synthetic_probe(3, 5000, 20000, gen, dev)
    bk[1] = -1                        # all padding, integer payloads summed
    bv[1] = torch.arange(5000, device=dev, dtype=torch.float32) % 97 - 48
    check_join_probe(bk, bv, pk, "an all-padding partition")
    check_join_probe(*colliding_probe(4000, 30000, gen, dev),
                     "keys in one hash chain")
    bk, bv, pk = synthetic_probe(2, 3000, 5000, gen, dev)
    bv[:, ::3] = -0.0
    check_join_probe(bk, bv, pk, "-0.0 payloads")
    bk[1, 17] = bk[1, 400]
    try:
        join_probe(bk, bv, pk, mode="cuda")
    except ValueError as e:
        log(f"join_probe duplicate build keys: refused ({e})")
    else:
        raise AssertionError("join_probe took duplicate build keys")


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
                                "bin tiles, ids out of range"),
                               (5, 777, 4, 64, "ragged rows")]:
        ids = torch.randint(-7, nb + 7, (P, T), device=dev,
                            dtype=torch.int32, generator=gen)
        vals = torch.randn((P, T, C), device=dev, generator=gen)
        check_hash_aggregate(ids, vals, nb, label)

    big = max(probes, key=lambda c: c[0][2].numel() * c[0][0].shape[1])
    bk, bv, pk = big[0]
    probe_err = check_join_probe(bk, bv, pk, "q3 main-path inputs (SF1)")
    join_probe_edges(gen, dev)
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
    # device time under torch.profiler: the small distributed call takes
    # less device time than the host needs to issue it, so CUDA events
    # around back-to-back calls read the host; those events beside it
    def run():
        return hash_aggregate_multi(ids, vals, n_bins=n_bins, mode="cuda")
    ms = device_ms(run, reps=20)
    with_host = cuda_ms(run, reps=20)
    us = host_us(run)
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
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                ms_with_host=with_host, host_us_per_call=us)


def time_join_probe(args, label, cut=None):
    """Kernel, plain and bound times at one probe's arguments. With
    ``cut`` = (partitions, probes a partition) the plain version, which
    compares every probe with every build key, runs on that cut only (the
    whole shape's cube is out of reach): the kernel's output at the whole
    shape must equal it there bit for bit, its time is reported as
    ``plain_ms_cut``, and ``plain_ms`` is "not measured"."""
    import torch
    from repro_torch.kernels.join_probe import join_probe
    from repro_torch.kernels.join_probe.ops import table_log2
    from repro_torch.kernels.join_probe.ref import join_probe_ref
    bk, bv, pk = args
    P, Bk = bk.shape
    Pk = pk.shape[1]
    # the wrapper reads the duplicate flag back (one host sync a call), so
    # the kernel's time is its device time; the events' time beside it
    ms = device_ms(lambda: join_probe(bk, bv, pk, mode="cuda"), reps=20)
    with_sync = cuda_ms(lambda: join_probe(bk, bv, pk, mode="cuda"),
                        reps=20)
    extra = {}
    if cut is None:
        plain = cuda_ms(lambda: join_probe_ref(bk, bv, pk), reps=1)
    else:
        cp, cq = cut
        plain = "not measured"
        v, f = join_probe(bk, bv, pk, mode="cuda")
        v, f = v[:cp, :cq], f[:cp, :cq]
        ref = []
        cut_ms = cuda_ms(lambda: ref.append(join_probe_ref(
            bk[:cp], bv[:cp], pk[:cp, :cq])), reps=1, warmup=0)
        rv, rf = ref[0]
        if not (torch.equal(v.view(torch.int32), rv.view(torch.int32))
                and torch.equal(f, rf)):
            raise AssertionError(
                f"join_probe {label}: differs from the plain version on "
                f"its first {cp} partition(s) x {cq} probes "
                f"({int((v != rv).sum())} vals, {int((f != rf).sum())} "
                "found)")
        log(f"join_probe {label}: the whole shape's output bit-equal to "
            f"the plain version on {cp} partition(s) x {cq} probes "
            f"({int(f.sum())} found)")
        extra = dict(plain_ms_cut=cut_ms,
                     plain_cut=f"build ({cp}, {Bk}), probe ({cp}, {cq})",
                     max_abs_err=float((v - rv).abs().max()))
    n_bytes = 8 * P * Bk + 4 * P * Pk + 5 * P * Pk
    # The function's own work: build keys are unique apart from the -1
    # padding, so one insert per build slot and one lookup per probe slot.
    # The hashed design also clears its table (8 bytes an entry, 2^cap_log2
    # >= 2 Bk entries a partition) once; that is reported apart, as the
    # design's floor.
    b_ms, b_by = bound_ms(n_bytes, float(P * (Bk + Pk)))
    design_ms = bound_ms(n_bytes + 8 * P * (1 << table_log2(Bk)),
                         float(P * (Bk + Pk)))[0]
    return dict(shape=f"{label}: build ({P}, {Bk}), probe ({P}, {Pk})",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, design_floor_ms=design_ms,
                ms_with_host_sync=with_sync, **extra)


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
# (printed on the "sums:" line; PERF.md has them). The kernel context sums
# rows in short chunks and adds the chunk partials in order; 1e-5 still
# fails a fused path that loses 15 of q1's 1.5M rows per group. The plain
# path's segment sums (sorted, a tree per hot group) read 2.6e-7 at most on
# an H100 80GB HBM3 at 700 W, so every context is held to 1e-5.
SUM_RTOL = {"kernel": 1e-5, "plain": 1e-5, "cost": 1e-5}
SINGLE_DEVICE_KERNELS = ("hash_aggregate_multi", "join_probe")
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
    for name in SINGLE_DEVICE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    warm = {c: {q: cuda_ms(lambda q=q, ctx=ctx: run_query(q, data,
                                                          context=ctx),
                           reps=WARM_REPS, warmup=0)
                for q in LOGICAL_QUERIES} for c, ctx in ctxs.items()}
    return results, launches, warm


# ---------------------------------------------------------------------------
# phase 5: block_histograms against its plain version; R2's bit-stable sums
# ---------------------------------------------------------------------------
N_SHARDS = 8
POLICIES = ("FIRST_TOUCH", "LOCAL_ALLOC", "INTERLEAVE", "PREFERRED")


def check_block_histograms(keys, n_bins, shift, block, label):
    """Kernel vs plain version: the counts must be equal."""
    import torch
    from repro_torch.kernels.radix_partition import block_histograms
    from repro_torch.kernels.radix_partition.ref import block_histograms_ref
    got = block_histograms(keys, n_bins=n_bins, shift=shift, block=block,
                           mode="cuda")
    want = block_histograms_ref(keys, n_bins=n_bins, shift=shift,
                                block=block)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or not torch.equal(got, want):
        raise AssertionError(f"block_histograms {label}: differs from the "
                             f"plain version in {int((got != want).sum())} "
                             "counts")
    return 0


def radix_phase(data, dev):
    """Capture the radix Exchange's block_histograms inputs on the
    distributed path at SF1 (8 shards), hold the kernel against its plain
    version there and on radix-digit edge cases, and check the ops built
    on it at an unaligned N."""
    import numpy as np
    import torch
    from repro_torch.analytics import engine, planner
    from repro_torch.analytics.tpch import run_query
    from repro_torch.core.config import PlacementPolicy
    from repro_torch.kernels.radix_partition import (padded_bin_counts,
                                                     radix_partition)

    ctx = planner.ExecutionContext(
        n_shards=N_SHARDS, policy=PlacementPolicy.INTERLEAVE,
        dist_join="partitioned", exchange_impl="radix")
    calls = []
    with capture(engine, "block_histograms", calls):
        run_query("q3", data, context=ctx)
    torch.cuda.synchronize()
    shapes = sorted({(a[0].shape[0], kw["n_bins"], kw["block"])
                     for a, kw in calls})
    for args, kw in calls:
        check_block_histograms(args[0], kw["n_bins"], kw["shift"],
                               kw["block"], "q3 route owners")
    log(f"block_histograms q3 route owners (SF1, {N_SHARDS} shards): "
        f"{len(calls)} calls, (N, n_bins, block) {shapes}, all equal")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_cases = 0
    for n_bins, shift, block in ([(256, s, 256) for s in (0, 8, 16, 24)]
                                 + [(8, 0, 128), (8, 0, 1024), (256, 8, 128),
                                    (256, 16, 1024), (2, 31, 256)]):
        keys = torch.randint(-(1 << 31), (1 << 31) - 1, (block * 977,),
                             device=dev, dtype=torch.int32, generator=gen)
        keys[::5] = -1                                # routing padding
        check_block_histograms(keys, n_bins, shift, block,
                               f"bins {n_bins} shift {shift} block {block}")
        n_cases += 1
    log(f"block_histograms: {n_cases} radix-digit cases (negative keys, "
        "-1 sentinels, bins 2-256, shifts 0-31, blocks 128-1024) equal")

    n = 1_000_003                                     # not a block multiple
    keys = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), device=dev,
                         dtype=torch.int32, generator=gen)
    k_np = keys.cpu().numpy()
    for shift in (0, 8):
        digits = (k_np.view(np.uint32) >> shift) & 63
        counts = padded_bin_counts(keys, n_bins=64, shift=shift, block=1024)
        if not np.array_equal(counts.cpu().numpy(),
                              np.bincount(digits, minlength=64)):
            raise AssertionError(f"padded_bin_counts shift {shift} differs")
        ko, vo, starts = radix_partition(keys, keys.to(torch.float32),
                                         n_bins=64, shift=shift, block=1024)
        order = np.argsort(digits, kind="stable")
        want = np.cumsum(np.bincount(digits, minlength=64))
        if not (np.array_equal(ko.cpu().numpy(), k_np[order])
                and np.array_equal(starts.cpu().numpy(),
                                   want - np.bincount(digits,
                                                      minlength=64))):
            raise AssertionError(f"radix_partition shift {shift} differs")
    log(f"padded_bin_counts / radix_partition at N={n}: equal to numpy")
    return max(calls, key=lambda c: c[0][0].shape[0])


def start_no_work_build():
    """Start nvcc on block_histograms' launch-floor build (``-DBH_NO_WORK``:
    the kernel's grid, zeros written, no key read), beside the kernels'
    own build. Returns (process, library path)."""
    from repro_torch.kernels import build
    out = build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libradix_partition_no_work.so"
    src = build.CSRC / build.SOURCES["radix_partition"]
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-DBH_NO_WORK",
                             "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def finish_no_work_build(started):
    proc, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the no-work build:\n{out}")
    return lib


def time_block_histograms(args, kw, label, no_work_lib):
    import ctypes
    import torch
    from repro_torch.kernels.common import stream_handle
    from repro_torch.kernels.radix_partition import block_histograms
    from repro_torch.kernels.radix_partition.ops import _bind
    from repro_torch.kernels.radix_partition.ref import (block_histograms_ref,
                                                         radix_digits)
    keys = args[0]
    n_bins, shift, block = kw["n_bins"], kw["shift"], kw["block"]
    N = keys.shape[0]
    # device time under torch.profiler (the call is host-bound: CUDA events
    # around back-to-back calls read the host's issue rate; kept beside it)
    def run():
        return block_histograms(keys, n_bins=n_bins, shift=shift, block=block,
                                mode="cuda")
    ms = device_ms(run, reps=50)
    # the launch floor: the same grid writing zeros, no key read
    floor_fn = getattr(ctypes.CDLL(str(no_work_lib)),
                       "block_histograms_launch")
    floor_fn.restype, floor_fn.argtypes = ctypes.c_int, _bind().argtypes
    zeros = torch.empty((N // block, n_bins), dtype=torch.int32,
                        device=keys.device)

    def floor():
        rc = floor_fn(keys.data_ptr(), zeros.data_ptr(), N // block, block,
                      n_bins, shift, stream_handle(keys.device))
        if rc != 0:
            raise RuntimeError(f"no-work build: CUDA error {rc}")
    no_work = device_ms(floor, reps=50)
    with_host = cuda_ms(run, reps=50)
    us = host_us(run)
    plain = cuda_ms(lambda: block_histograms_ref(keys, n_bins=n_bins,
                                                 shift=shift, block=block),
                    reps=20)
    # one library call for the same counts, on the flat (block, digit) index
    n_blocks = N // block
    flat = (torch.arange(N, device=keys.device) // block * n_bins
            + radix_digits(keys, n_bins, shift))
    lib = cuda_ms(lambda: torch.bincount(flat, minlength=n_blocks * n_bins),
                  reps=20)
    b_ms, b_by = bound_ms(4 * N + 4 * n_blocks * n_bins, N)
    return dict(shape=f"{label}: keys ({N},) int32, n_bins {n_bins}, "
                f"block {block}", ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, ms_with_host=with_host,
                host_us_per_call=us, no_work_ms=no_work)


def r2_phase(data):
    """The plain path's float segment sums are the same bits on every run
    (ROADMAP Queue 3, R2): q1's and q18's SF1 shapes, run twice."""
    import torch
    from repro_torch.analytics.columnar import segment_sum
    li = data.tables["lineitem"]
    n_orders = data.tables["orders"]["o_orderkey"].shape[0]
    g1 = li["l_returnflag"] * 2 + li["l_linestatus"]
    stacked = torch.stack([li["l_quantity"], li["l_extendedprice"],
                           li["l_discount"]], dim=1)
    cases = {"q1 (6 groups)": (li["l_extendedprice"], g1, 6),
             "q1 stacked (6 groups, 3 columns)": (stacked, g1, 6),
             "q18 (orders groups)": (li["l_quantity"], li["l_orderkey"],
                                     n_orders)}
    times = {}
    for label, (vals, ids, n) in cases.items():
        a = segment_sum(vals, ids, n)
        b = segment_sum(vals, ids, n)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"segment_sum {label}: two runs differ")
        ms = cuda_ms(lambda: segment_sum(vals, ids, n), reps=5)
        idx = ids.to(torch.int64)
        atomics = cuda_ms(lambda: torch.zeros((n,) + tuple(vals.shape[1:]),
                                              device=vals.device)
                          .index_add_(0, idx, vals), reps=5)
        times[label] = dict(rows=int(vals.shape[0]), ms=ms,
                            index_add_ms=atomics)
    log(f"R2: segment_sum bit-equal across two runs at {sorted(cases)}; "
        f"ms {json.dumps(times)}")
    return times


# ---------------------------------------------------------------------------
# phase 6: the distributed path at SF1 on 8 virtual shards
# ---------------------------------------------------------------------------
def dist_contexts():
    from repro_torch.analytics import planner
    from repro_torch.core.config import PlacementPolicy
    out = {}
    for pol in POLICIES:
        p = PlacementPolicy[pol]
        for impl in ("argsort", "radix"):
            out[f"{impl}/{pol}"] = planner.ExecutionContext(
                n_shards=N_SHARDS, policy=p, dist_join="partitioned",
                exchange_impl=impl)
        out[f"cost/{pol}"] = planner.ExecutionContext(n_shards=N_SHARDS,
                                                      policy=p)
    out["composed/INTERLEAVE"] = planner.ExecutionContext(
        n_shards=N_SHARDS, policy=PlacementPolicy.INTERLEAVE,
        executor="kernel", exchange_impl="radix", dist_join="partitioned")
    return out


# A distributed sum adds each shard's partial in f32 and the shards' in rank
# order; its error against float64 is held to the single-device limit (the
# readings on an H100 80GB HBM3 at 700 W were at most 1.3e-7).
DIST_SUM_RTOL = {"argsort": 1e-5, "radix": 1e-5, "cost": 1e-5,
                 "composed": 1e-5}
RETRY_CAPACITY = 4.0     # routing capacity factor of an overflowed re-run


def same_bits(a, b) -> bool:
    """Equal dicts of tensors, NaN equal to NaN."""
    import torch
    if set(a) != set(b):
        return False
    return all(x.dtype == b[k].dtype and x.shape == b[k].shape
               and torch.equal(torch.nan_to_num(x, nan=-7.0),
                               torch.nan_to_num(b[k], nan=-7.0))
               for k, x in a.items())


def check_against_plain(label, got, ref, oracle, rtol, worst):
    """One query's outputs against the single-device plain path (exact
    keys) and the float64 evaluation (sums, held to ``rtol``)."""
    import numpy as np
    import torch
    name = label.split("/")[-1]
    if set(got) != set(ref):
        raise AssertionError(f"{label}: keys {sorted(got)}")
    for k, v in got.items():
        v, r = v.cpu(), ref[k].cpu()
        if v.shape != r.shape:
            raise AssertionError(f"{label}/{k}: shape {v.shape}")
        if k in EXACT_KEYS or not v.is_floating_point():
            if not torch.equal(torch.nan_to_num(v, nan=-7.0),
                               torch.nan_to_num(r, nan=-7.0)):
                raise AssertionError(f"{label}/{k}: differs from the "
                                     "single-device plain path")
        elif not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}/{k}: not finite")
    for k, want in oracle.get(name, {}).items():
        want = want.cpu().numpy()
        g = got[k].to(torch.float64).cpu().numpy()
        if name == "q3":
            want = np.sort(want)[::-1][:10]
        r = rel_dev(g, want)
        if r > worst[0]:
            worst[:] = [r, f"{label}/{k}"]
        if r > rtol:
            raise AssertionError(f"{label}/{k}: off float64 by {r!r} "
                                 f"relative, over {rtol}")


def dist_main_path(data, plain, oracle):
    """Drive the 7 queries under every distributed context, check them, and
    time them warm. Returns (launches, warm ms, peak bytes)."""
    import dataclasses
    import torch
    from repro_torch.analytics.tpch import LOGICAL_QUERIES, run_query
    from repro_torch.kernels import common

    ctxs = dist_contexts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()                 # just before the path
    t0 = time.perf_counter()
    results = {c: {q: run_query(q, data, context=ctx)
                   for q in LOGICAL_QUERIES} for c, ctx in ctxs.items()}
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)        # just after it
    peak = torch.cuda.max_memory_allocated()
    log(f"distributed path: 7 queries x {len(ctxs)} contexts on "
        f"{N_SHARDS} virtual shards in {time.perf_counter() - t0:.3f} s "
        f"(first runs), launches {launches}, peak {peak / 2**30:.3f} GiB")
    for name in ("block_histograms", "hash_aggregate_multi"):
        if launches[name] <= 0:
            raise AssertionError(f"the distributed path never launched "
                                 f"{name}")

    # _overflow: 0, or stated and the query re-run with more capacity
    overflowed = {(c, q): int(r["_overflow"])
                  for c, res in results.items() for q, r in res.items()
                  if "_overflow" in r and int(r["_overflow"]) != 0}
    for (c, q), ovf in sorted(overflowed.items()):
        log(f"overflow stated: {q} under {c}: {ovf} records beyond the "
            f"routing capacity (capacity_factor "
            f"{ctxs[c].capacity_factor}); re-run at {RETRY_CAPACITY}")
    worst = {kind: [0.0, ""] for kind in DIST_SUM_RTOL}
    for c, res in results.items():
        kind = c.split("/")[0]
        for q, got in res.items():
            if (c, q) in overflowed:
                ctx = dataclasses.replace(ctxs[c],
                                          capacity_factor=RETRY_CAPACITY)
                got = run_query(q, data, context=ctx)
                if int(got["_overflow"]) != 0:
                    raise AssertionError(f"{q} under {c}: overflow at "
                                         f"capacity {RETRY_CAPACITY}")
            check_against_plain(f"{c}/{q}", got, plain[q], oracle,
                                DIST_SUM_RTOL[kind], worst[kind])
    log("distributed sums: largest relative deviation from float64 "
        + ", ".join(f"[{k}] {r!r} ({label})" for k, (r, label)
                    in worst.items()))
    for pol in POLICIES:
        for q in LOGICAL_QUERIES:
            if not same_bits(results[f"argsort/{pol}"][q],
                             results[f"radix/{pol}"][q]):
                raise AssertionError(f"{q} under {pol}: the argsort and "
                                     "radix layouts give different bits")
        top = {m: run_query("q3", data, context=dataclasses.replace(
            ctxs[f"argsort/{pol}"], dist_topk=m))
            for m in ("candidates", "replicated")}
        if not same_bits(top["candidates"], top["replicated"]):
            raise AssertionError(f"q3 under {pol}: candidates TopK differs "
                                 "from replicated")
    for c in ("radix/INTERLEAVE", "cost/FIRST_TOUCH"):
        for q in LOGICAL_QUERIES:
            if not same_bits(run_query(q, data, context=ctxs[c]),
                             results[c][q]):
                raise AssertionError(f"{q} under {c}: a second run gives "
                                     "other bits")
    log("distributed results: the plain path's integers, counts, order "
        "statistics and o_orderkey under every context; argsort == radix "
        "and candidates == replicated bit for bit; second runs "
        "bit-identical")
    warm = {c: {q: cuda_ms(lambda q=q, ctx=ctx: run_query(q, data,
                                                          context=ctx),
                           reps=WARM_REPS, warmup=0)
                for q in LOGICAL_QUERIES} for c, ctx in ctxs.items()}
    for c, q in (("radix/INTERLEAVE", "q5"), ("cost/FIRST_TOUCH", "q3"),
                 ("cost/FIRST_TOUCH", "q1")):
        log(f"device share [{c} {q}]: " + json.dumps(device_share(
            lambda: run_query(q, data, context=ctxs[c]))))
    return launches, warm, peak, sorted(overflowed)


def dist_aggregate_call(data):
    """The arguments of the largest hash_aggregate_multi call (by ids and
    values moved) of the 7 queries under composed/INTERLEAVE, the
    distributed context that launches it: one shard's rows."""
    from repro_torch.analytics import columnar
    from repro_torch.analytics.tpch import LOGICAL_QUERIES, run_query
    calls = []
    ctx = dist_contexts()["composed/INTERLEAVE"]
    with capture(columnar, "hash_aggregate_multi", calls):
        for q in LOGICAL_QUERIES:
            run_query(q, data, context=ctx)
    shapes = sorted({(tuple(a[0].shape), a[1].shape[2], kw["n_bins"])
                     for a, kw in calls})
    log(f"hash_aggregate under composed/INTERLEAVE: {len(calls)} calls, "
        f"(ids shape, C, n_bins) {shapes}")

    def moved(call):                  # ids and values read, tables written
        (ids, vals), n_bins = call[0][:2], call[1]["n_bins"]
        P, T, C = vals.shape
        return P * T * (1 + C) + P * n_bins * C
    return max(calls, key=moved)


def device_share(fn):
    """Wall ms of one warm call (host clock, synchronized, no profiler)
    beside the device's busy ms (the CUDA kernels' and copies' self time
    under torch.profiler, ``device_sessions``; one stream, so they do not
    overlap), the count of device operations, and the count of calls
    that waited for the device (torch's sync debug mode)."""
    import warnings
    import torch
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ops, busy_us, _ = device_sessions(fn, 1)
    busy = busy_us / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy, device_ops=ops,
                idle_share=1 - busy / wall,
                host_syncs=sum("synchroniz" in str(w.message)
                               for w in caught))


# ---------------------------------------------------------------------------
# phase 6b: telemetry and tracing on the card (SF1)
# ---------------------------------------------------------------------------
def telemetry_phase(data):
    """The 7 queries under ``cost`` and ``kernel`` on one device and
    ``composed`` on 8 virtual shards, tracked (telemetry recording) against
    untracked: the same bits, one registry execution per plan, every
    counter >= 0. The launch counts are zeroed just before the tracked
    runs and read just after. Prints explain_analyze of q3 on 8 shards,
    warm ms, device operations and host syncs per call tracked against
    untracked, and checks that a traced compile and execute leaves no
    open span. Returns the tracked runs' launches."""
    import dataclasses
    import torch
    from repro_torch.analytics import planner, telemetry, tracing
    from repro_torch.analytics.tpch import LOGICAL_QUERIES, run_query
    from repro_torch.kernels import common

    ctxs = {"cost": planner.ExecutionContext(executor="cost"),
            "kernel": planner.ExecutionContext(**CONTEXTS["kernel"]),
            "composed": dist_contexts()["composed/INTERLEAVE"]}
    tables = data.tables
    plain = {c: {q: planner.compile_plan(p, tables, ctx)
                 for q, p in LOGICAL_QUERIES.items()}
             for c, ctx in ctxs.items()}
    reg = telemetry.registry()
    reg.clear()
    with telemetry.recording():
        tracked = {c: {q: planner.compile_plan(p, tables, ctx)
                       for q, p in LOGICAL_QUERIES.items()}
                   for c, ctx in ctxs.items()}
    want = {c: {q: cp(tables) for q, cp in per.items()}
            for c, per in plain.items()}
    torch.cuda.synchronize()
    common.reset_launches()                 # just before the tracked runs
    got = {c: {q: cp(tables) for q, cp in per.items()}
           for c, per in tracked.items()}
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)        # just after them
    for name in ("hash_aggregate_multi", "join_probe", "block_histograms"):
        if launches[name] <= 0:
            raise AssertionError(f"the tracked runs never launched {name}")
    for c in ctxs:
        for q in LOGICAL_QUERIES:
            cp = tracked[c][q]
            if "_stats" in got[c][q] or not same_bits(got[c][q], want[c][q]):
                raise AssertionError(f"{q} under {c}: the tracked run "
                                     "differs from the untracked one")
            ps = reg.get(cp.cache_key)
            if ps is None or ps.executions != 1 or not ps.nodes:
                raise AssertionError(f"{q} under {c}: registry holds "
                                     f"{ps and ps.executions} executions")
            bad = [(i, ns.last) for i, ns in ps.nodes.items()
                   if any(v < 0 for v in ns.last.values())]
            if bad:
                raise AssertionError(f"{q} under {c}: negative counters "
                                     f"{bad}")
    log(f"telemetry: 7 queries x {sorted(ctxs)} tracked give the untracked "
        f"bits; registry {json.dumps(reg.summary())}; launches {launches}")
    text = telemetry.explain_analyze(LOGICAL_QUERIES["q3"], tables,
                                     ctxs["composed"])
    log(f"explain_analyze q3, composed/INTERLEAVE, {N_SHARDS} shards:\n"
        f"{text}")

    costs = {}
    for c in ctxs:
        for q in LOGICAL_QUERIES:
            row = {}
            for kind, cp in (("untracked", plain[c][q]),
                             ("tracked", tracked[c][q])):
                share = device_share(lambda cp=cp: cp(tables))
                row[kind] = dict(warm_ms=cuda_ms(lambda cp=cp: cp(tables),
                                                 reps=WARM_REPS, warmup=0),
                                 device_ops=share["device_ops"],
                                 device_busy_ms=share["device_busy_ms"],
                                 idle_share=share["idle_share"],
                                 host_syncs=share["host_syncs"])
            extra = row["tracked"]["host_syncs"] - row["untracked"][
                "host_syncs"]
            if extra > 1:
                raise AssertionError(f"{q} under {c}: recording added "
                                     f"{extra} host syncs a call, not 1")
            costs[f"{c}/{q}"] = row
    log(f"telemetry cost per call (warm ms, device ops, busy ms, idle "
        f"share, host syncs): "
        f"{json.dumps(costs)}")
    reg.clear()

    fresh = dataclasses.replace(ctxs["cost"], capacity_factor=2.5)
    with tracing.tracing() as tr:
        tr.clear()
        run_query("q5", data, context=fresh)          # a cache miss
        spans, open_left = tr.spans(), tr.open_spans()
        tr.clear()
    names = [sp.name for sp in spans]
    if open_left or names != ["plan.compile", "plan.execute"]:
        raise AssertionError(f"tracing: spans {names}, open {open_left}")
    log("tracing: a traced compile and execute gave "
        + ", ".join(f"{sp.name} {sp.dur * 1e3:.3f} ms" for sp in spans)
        + " (host clock: the execute span covers the host's issue), no "
        "open span")
    return launches


# ---------------------------------------------------------------------------
# phase 7: W1 / W2 / W3 under the four policies at the paper's sizes
# ---------------------------------------------------------------------------
W_RECORDS, W_CARD = 100_000_000, 1_000_000      # W1/W2 (datasets.py)
W_BUILD, W_PROBE = 16_000_000, 256_000_000      # W3 (blanas_join)
# W3's count and checksum are f32 sums (a tree over up to 32M rows per
# shard, then 8 partials). Read against float64 on an H100 80GB HBM3 at
# 700 W: 6.25e-8 (the count under INTERLEAVE, 16 of 256M rows) and 4.2e-8
# (the checksum). The limit is 16x the larger reading, under the tree's
# worst case (~1.5e-6).
W_SUM_RTOL = 1e-6


class WData:
    """W1-W4's tensors at the paper's sizes, made once on the card and
    shared by phases 7 and 7b, with their oracles (each computed once):
    float64 checksums of the probe prefixes a cut may take, bincount, and
    a sort oracle for the medians."""

    def __init__(self, dev):
        import torch
        from repro_torch.analytics import datasets as D
        t0 = time.perf_counter()
        agg = D.to_tensors(D.zipf(W_RECORDS, W_CARD, exponent=0.5,
                                  seed=SEED), dev)
        join = D.to_tensors(D.blanas_join(W_BUILD, W_PROBE, seed=SEED), dev)
        torch.cuda.synchronize()
        log(f"W data: zipf({W_RECORDS}, {W_CARD}, e=0.5), blanas_join("
            f"{W_BUILD}, {W_PROBE}), seed {SEED}, in "
            f"{time.perf_counter() - t0:.3f} s")
        self.keys, self.vals = agg["keys"], agg["vals"]
        self.bk, self.bv = join["build_keys"], join["build_vals"]
        self.pk = join["probe_keys"]
        order = torch.argsort(self.bk)
        pos = torch.clamp(torch.searchsorted(self.bk[order], self.pk),
                          max=W_BUILD - 1)
        if not torch.equal(self.bk[order][pos], self.pk):
            raise AssertionError("W3 data: a probe key has no build key")
        matched = self.bv.to(torch.float64)[order[pos]]
        self.sum_ref = {W_PROBE >> c: float(matched[:W_PROBE >> c].sum())
                        for c in range(3)}
        self._refs = {}

    def ref(self, kind, n):
        import torch
        if (kind, n) not in self._refs:
            k, v = self.keys[:n], self.vals[:n]
            counts = torch.bincount(k, minlength=W_CARD)
            if kind == "count":
                self._refs[kind, n] = counts.to(torch.float32)
            else:
                # an oracle apart from segment_median: one sort on (key,
                # value) packed in int64 (values in [0, 1) order as their
                # bits), exact int64 run starts
                packed = (k.to(torch.int64) << 32) | v.view(torch.int32)
                sv = v[torch.argsort(packed)]
                starts = torch.cumsum(counts, 0) - counts
                lo = torch.clamp(starts + (counts - 1) // 2, 0, n - 1)
                hi = torch.clamp(starts + counts // 2, 0, n - 1)
                self._refs[kind, n] = torch.where(counts > 0,
                                                  (sv[lo] + sv[hi]) * 0.5,
                                                  torch.nan)
        return self._refs[kind, n]


def w_phase(wd, dev):
    """dist_median / dist_count / dist_hash_join on 8 virtual shards under
    each policy, against single-device evaluations of the same data. A
    run that exhausts device memory is cut to the first half of its
    records (at most twice) and the cut is printed."""
    import gc
    import torch
    from repro_torch.analytics.engine import (dist_count, dist_hash_join,
                                              dist_median)
    from repro_torch.core.config import PlacementPolicy

    keys, vals, bk, bv, pk = wd.keys, wd.vals, wd.bk, wd.bv, wd.pk

    def w2(p, n):
        got = dist_count(N_SHARDS, p, W_CARD, device=dev)(keys[:n])
        if not torch.equal(got, wd.ref("count", n)):
            raise AssertionError(f"W2 {p.name}: counts differ")
        return {}

    def w1(p, n):
        got = dist_median(N_SHARDS, p, W_CARD, device=dev)(keys[:n],
                                                           vals[:n])
        if not torch.equal(torch.nan_to_num(got, -7.0),
                           torch.nan_to_num(wd.ref("median", n), -7.0)):
            raise AssertionError(f"W1 {p.name}: medians differ from the "
                                 "sort oracle")
        return {}

    def w3(p, n):
        c, s = dist_hash_join(N_SHARDS, p, device=dev)(bk, bv, pk[:n])
        rc = abs(float(c) - n) / n
        rs = abs(float(s) - wd.sum_ref[n]) / abs(wd.sum_ref[n])
        if max(rc, rs) > W_SUM_RTOL:
            raise AssertionError(f"W3 {p.name}: count {float(c)} of {n}, "
                                 f"checksum off float64 by {rs!r}")
        return dict(count=float(c), count_rel_dev=rc, checksum_rel_dev=rs)

    cuts = []
    out = {}
    for pol in POLICIES:
        p = PlacementPolicy[pol]
        row = {}
        for wl, run, full in (("W2", w2, W_RECORDS), ("W1", w1, W_RECORDS),
                              ("W3", w3, W_PROBE)):
            n = full
            while True:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                try:
                    row[wl] = run(p, n)
                    torch.cuda.synchronize()
                    break
                except torch.cuda.OutOfMemoryError:
                    gc.collect()
                    torch.cuda.empty_cache()
                    if n <= full >> 2:
                        raise
                    cuts.append(f"{wl} {pol}: out of device memory at {n} "
                                f"records, cut to {n // 2}")
                    log(f"CUT: {cuts[-1]}")
                    n //= 2
            row[wl].update(records=n, s=time.perf_counter() - t,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        out[pol] = row
        log(f"W1-W3 {pol}: {json.dumps(row)}")
    counts = dist_count(N_SHARDS, PlacementPolicy.FIRST_TOUCH, W_CARD,
                        auto_rebalance=True, device=dev)(keys)
    if not torch.equal(counts, wd.ref("count", W_RECORDS)):
        raise AssertionError("W2 FIRST_TOUCH auto_rebalance: counts differ")
    log("W1-W3: medians equal a single-device sort oracle, counts "
        "equal bincount (also after auto_rebalance under FIRST_TOUCH), W3 "
        f"counts and checksums within {W_SUM_RTOL} of float64; cuts: "
        f"{cuts or 'none'}")
    return out


# ---------------------------------------------------------------------------
# phase 7b: W1-W4 on one device at the paper's sizes
# ---------------------------------------------------------------------------
W_KERNELS = {"count_partitioned": ("hash_aggregate_multi",
                                   "agg_partial_kernel"),
             "hash_join": ("join_probe", "join_probe_kernel")}


def w_local_phase(wd):
    """W1-W4 through ``analytics.aggregate`` and ``analytics.join`` on one
    device at the paper's sizes (phase 7's tensors): counts against
    bincount, medians against the sort oracle, W3 and W4 counts and
    checksums against float64. The launch counts are zeroed just before
    the operators run and read just after; torch.profiler must also see
    each kernel launched inside its operator. Returns (launches, the two
    kernels' timings at these shapes)."""
    import torch
    from repro_torch.analytics import aggregate, columnar, join
    from repro_torch.kernels import common

    keys, vals, bk, bv, pk = wd.keys, wd.vals, wd.bk, wd.bv, wd.pk
    n, sum_ref = W_PROBE, wd.sum_ref[W_PROBE]

    def join_check(label, c, s, want_n, want_sum):
        # the count is an exact integer; only the f32 checksum has a limit
        rs = abs(float(s) - want_sum) / abs(want_sum)
        if int(c) != want_n or rs > W_SUM_RTOL:
            raise AssertionError(f"{label}: count {int(c)} of {want_n}, "
                                 f"checksum off float64 by {rs!r}")
        return dict(count=int(c), checksum_rel_dev=rs)

    def hash_index_oracle():
        """W4's hash index leaves out the keys its 16 rounds of linear
        probing did not place (the reference's own bound): the count and
        checksum it must give are those of the probes whose key the table
        holds, with each key's value taken from the build input. The held
        keys come from the port's own build, so at this size the check is
        of the probe against that build (the tests hold the build to the
        reference's bits at small sizes); it also requires every held key
        to be a build key, held once."""
        idx = join.build_hash_index(bk, bv)
        sk = torch.sort(idx.table_keys[idx.table_keys >= 0]).values
        border = torch.argsort(bk)
        sbk = bk[border]
        at = torch.clamp(torch.searchsorted(sbk, sk), max=W_BUILD - 1)
        if bool((sk[1:] == sk[:-1]).any()) or not torch.equal(sbk[at], sk):
            raise AssertionError("W4 hash index: a table key is held twice "
                                 "or is not a build key")
        pos = torch.clamp(torch.searchsorted(sk, pk), max=sk.numel() - 1)
        hit = sk[pos] == pk
        del pos
        bpos = torch.clamp(torch.searchsorted(sbk, pk), max=W_BUILD - 1)
        want = float((bv.to(torch.float64)[border[bpos]] * hit).sum())
        return int(hit.sum()), want, W_BUILD - int(sk.numel()), idx.capacity

    ops = {
        "count_direct": lambda: aggregate.count_direct(keys, W_CARD),
        "count_partitioned": lambda: aggregate.count_partitioned(keys,
                                                                 W_CARD),
        "median_jit": lambda: aggregate.median_jit(keys, vals, W_CARD),
        "hash_join": lambda: join.hash_join(bk, bv, pk),
    }
    for kind in ("radix", "sorted", "hash"):
        ops[f"index_join/{kind}"] = (
            lambda kind=kind: join.index_join(bk, bv, pk, kind))

    torch.cuda.synchronize()
    common.reset_launches()                 # just before the operators
    rows, results = {}, {}
    for name, fn in ops.items():
        before = dict(common.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        rows[name] = dict(first_s=time.perf_counter() - t,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          launches={k: v - before[k] for k, v
                                    in common.LAUNCHES.items()
                                    if v - before[k]})
    launches = dict(common.LAUNCHES)        # just after them
    for name, (counter, _kernel) in W_KERNELS.items():
        if not rows[name]["launches"].get(counter):
            raise AssertionError(f"{name} never launched {counter}")

    # checks
    if not torch.equal(results["count_direct"], wd.ref("count", W_RECORDS)):
        raise AssertionError("W2 count_direct differs from bincount")
    counts, ovf = results["count_partitioned"]
    if int(ovf) != 0 or not torch.equal(counts, wd.ref("count", W_RECORDS)):
        raise AssertionError(f"W2 count_partitioned: overflow {int(ovf)}, "
                             "or counts differ from bincount")
    if not torch.equal(torch.nan_to_num(results["median_jit"], -7.0),
                       torch.nan_to_num(wd.ref("median", W_RECORDS), -7.0)):
        raise AssertionError("W1 median_jit differs from the sort oracle")
    c, s, ovf = results["hash_join"]
    if int(ovf) != 0:
        raise AssertionError(f"W3 hash_join: overflow {int(ovf)}")
    rows["hash_join"].update(join_check("W3 hash_join", c, s, n, sum_ref))
    for kind in ("radix", "sorted"):
        rows[f"index_join/{kind}"].update(join_check(
            f"W4 {kind}", *results[f"index_join/{kind}"], n, sum_ref))
    held_n, held_sum, unplaced, cap = hash_index_oracle()
    rows["index_join/hash"].update(join_check(
        "W4 hash", *results["index_join/hash"], held_n, held_sum),
        build_keys_unplaced=unplaced, probes_unmatched=n - held_n)
    log(f"W4 hash index: {unplaced} of {W_BUILD} build keys unplaced after "
        f"16 probes at load {W_BUILD / cap:.3f}, so {n - held_n} of "
        f"{n} probes unmatched (the reference's bound); the rest match")

    # warm seconds (CUDA events, after the first run above)
    for name, fn in ops.items():
        rows[name]["warm_s"] = cuda_ms(fn, reps=2, warmup=0) / 1e3
    for name, row in rows.items():
        log(f"W1-W4 one device [{name}]: {json.dumps(row)}")

    # torch.profiler sees each kernel inside its operator
    for name, (_counter, kernel) in W_KERNELS.items():
        seen = device_sessions(ops[name], 1)[2]
        hits = sum(v for k, v in seen.items() if kernel in k)
        if hits < 1:
            raise AssertionError(f"torch.profiler saw no {kernel} in {name}"
                                 f": {sorted(k[:60] for k in seen)}")
        log(f"torch.profiler: {hits} {kernel} launch(es) in {name}")
    log("W1-W4 one device: counts equal bincount (overflow 0), medians "
        "equal the sort oracle, W3 and W4 counts and checksums within "
        f"{W_SUM_RTOL} of float64; launches {launches}; cuts: none")

    # the two kernels at these shapes, as the main path's rows are timed
    agg_calls, probe_calls = [], []
    with capture(columnar, "hash_aggregate_multi", agg_calls), \
            capture(join, "join_probe", probe_calls):
        ops["count_partitioned"]()
        ops["hash_join"]()
    agg_t = time_hash_aggregate(*agg_calls[0], "W2 count_partitioned, "
                                f"zipf({W_RECORDS}, {W_CARD})")
    P, Pk = probe_calls[0][0][2].shape
    probe_t = time_join_probe(probe_calls[0][0], "W3 hash_join, blanas_join("
                              f"{W_BUILD}, {W_PROBE})",
                              cut=(1, Pk // P))
    for kind, t in (("hash_aggregate", agg_t), ("join_probe", probe_t)):
        log(f"{kind} timing (W1-W4 one device) {json.dumps(t)}")
    return launches, agg_t, probe_t


# ---------------------------------------------------------------------------
# phase 8: serving recurrentgemma-2b at full width (prefill + decode waves)
# ---------------------------------------------------------------------------
LM_ARCH = "recurrentgemma-2b"
LM_B, LM_S = 2, 4096            # prefill: twice the 2048 window
LM_DECODE = 64                  # decode-vs-forward tokens
SERVE_ARGV = ["--arch", LM_ARCH, "--requests", "32", "--wave-slots", "8",
              "--max-new", "16", "--seed", str(SEED)]
# The kernels and their plain versions sum the same float32 products in
# other orders: 1e-5 absolute and relative. Last-token logits after 26
# layers with kernels vs with plain versions: 1e-4. Decode against forward
# (float32 cache): 2e-3, the reference's own bound for that parity.
KERNEL_TOL, PREFILL_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-3


def held(got, want, tol, label):
    """Raise unless |got - want| <= tol + tol * |want| everywhere. Returns
    the largest absolute error and the largest share of that limit used."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)}, want "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: not finite")
    if got.numel() == 0:
        return 0.0, 0.0
    err = (got - want).abs()
    worst = float(err.max())
    share = float((err / (tol + tol * want.abs())).max())
    if share > 1.0:
        raise AssertionError(f"{label}: off by {worst!r}, {share!r} of the "
                             f"limit {tol} (absolute and relative)")
    return worst, share


def attention_pairs(Sq, Skv, q_offset, window):
    """(query, key) pairs the causal / window mask leaves visible, per
    (batch, head)."""
    import torch
    qpos = q_offset + torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(qpos, max=Skv - 1)
    lo = (torch.clamp(qpos - window + 1, min=0) if window is not None
          else torch.zeros_like(qpos))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def check_attention(q, k, v, label, window=None, q_offset=0, scale=None):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_chunked
    got = flash_attention(q, k, v, window=window, q_offset=q_offset,
                          scale=scale, mode="cuda")
    want = attention_chunked(q, k, v, window=window, q_offset=q_offset,
                             scale=scale)
    err, rel = held(got, want, KERNEL_TOL, f"flash_attention {label}")
    log(f"flash_attention {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"window {window} q_offset {q_offset}: max_abs_err {err!r} "
        f"limit share {rel!r}")
    return got, err


def check_scan(a, b, label, chunk=None):
    """Through the dispatching wrapper; a chunk other than the kernel's own
    goes to the launcher, which alone takes one. The kernel's order is
    fixed, so two runs must give the same bits."""
    import torch
    from repro_torch.kernels.rglru_scan.ops import CHUNK, _launch, linear_scan
    from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential
    if chunk is None:
        got, again = (linear_scan(a, b, mode="cuda") for _ in range(2))
    else:
        got, again = (_launch(a, b, chunk=chunk) for _ in range(2))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"rglru_scan {label}: two runs differ")
    want = linear_scan_sequential(a, b)
    err, rel = held(got, want, KERNEL_TOL, f"rglru_scan {label}")
    log(f"rglru_scan {label}: {tuple(a.shape)} chunk {chunk or CHUNK}: "
        f"max_abs_err {err!r} limit share {rel!r}, two runs bit-equal")
    return err


def lm_kernel_edges(dev):
    """The two kernels against their plain versions off the main path's
    shapes: other head dims, GQA 7:1, offsets, ragged tiles, rows that see
    no key, scan lengths and chunks that do not divide."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    for D, Hq, Hkv, S, Skv, window, off, label in [
            (64, 14, 2, 1000, 1000, None, 0,
             "qwen2-0.5b heads (GQA 7:1, D 64)"),
            (128, 16, 8, 777, 777, 300, 0,
             "D 128, window 300, S not a tile multiple"),
            (256, 10, 1, 333, 4429, 2048, 4096,
             "q_offset 4096 (a chunk of a longer prefill)"),
            (64, 4, 4, 200, 100, 20, 500,
             "rows that see no key (keys 0-99, rows from 500, window 20)")]:
        q, k, v = rnd(2, S, Hq, D), rnd(2, Skv, Hkv, D), rnd(2, Skv, Hkv, D)
        got, _ = check_attention(q, k, v, label, window=window,
                                 q_offset=off)
        hidden = window is not None and Skv <= off - window
        if hidden and not torch.equal(got, torch.zeros_like(got)):
            raise AssertionError("flash_attention: a row that sees no key "
                                 "is not 0")
    for shape, chunk, label in [((2, 4097, 2560), None, "S not a chunk "
                                 "multiple"), ((1, 1, 300), None, "S 1"),
                                ((3, 1000, 130), 7, "chunk 7")]:
        a = torch.rand(shape, device=dev, generator=gen) * 0.98 + 0.01
        check_scan(a, rnd(*shape), label, chunk)
    # the RG-LRU's own regime: decays near 1, b scaled by sqrt(1 - a^2)
    a = torch.rand((2, 4096, 2560), device=dev, generator=gen) * 0.00099 \
        + 0.999
    b = rnd(2, 4096, 2560) * torch.sqrt(1 - a.double() ** 2).float()
    check_scan(a, b, "near-1 decays (a in [0.999, 0.99999])")


def device_breakdown(fn):
    """Device ms of one warm call of ``fn`` by kind of kernel (self CUDA
    time under torch.profiler), beside its wall ms and the count of device
    operations it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, ops = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ops += e.count
        name = e.key.lower()
        kind = ("flash_attention" if "fa_fwd" in name else
                "rglru_scan" if "scan_" in name else
                "wkv6" if "wkv6" in name else
                "matmul" if any(w in name for w in ("gemm", "cutlass",
                                                    "xmma", "sm90")) else
                "other")
        kinds[kind] = kinds.get(kind, 0.0) + getattr(
            e, "self_device_time_total", 0) / 1e3
    busy = sum(kinds.values())
    return dict(wall_ms=wall, device_busy_ms=busy or "not measured",
                idle_share=(1 - busy / wall) if busy else "not measured",
                device_ops=ops, device_ms_by_kind=kinds)


def lm_prefill_checks(model, plain, params, batch, logits, label):
    """Prefill logits with the kernels against the plain versions'
    prefill, then the warm prefill's time, peak memory and device time by
    kind. Run under torch.no_grad()."""
    import torch
    want, _ = plain.prefill(params, batch)
    err, rel = held(logits, want, PREFILL_TOL, f"{label} prefill logits")
    log(f"{label} prefill logits, kernels vs plain: max_abs_err {err!r}, "
        f"limit share {rel!r} (|logit| up to {float(want.abs().max())!r})")
    del want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.prefill(params, batch), reps=WARM_REPS,
                 warmup=1)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} prefill warm: {ms!r} ms per prefill of {LM_B}x{LM_S} "
        f"tokens ({LM_B * LM_S / ms * 1e3:.1f} tokens/s), peak "
        f"{peak / 2**30:.3f} GiB")
    log(f"{label} prefill device time: " + json.dumps(device_breakdown(
        lambda: model.prefill(params, batch))))


def lm_decode_vs_forward(arch, params, tokens, dev, label):
    """LM_DECODE decode steps with a float32 cache against the forward
    pass over the same tokens. Run under torch.no_grad()."""
    import torch
    from repro_torch.models.lm import LMModel
    m32 = LMModel(arch, device=dev, cache_dtype=torch.float32)
    toks = tokens[:, :LM_DECODE]
    full, _, _ = m32.forward(params, {"tokens": toks})
    cache = m32.init_cache(LM_B, LM_DECODE + 1)
    worst = 0.0
    for t in range(LM_DECODE):
        step, cache = m32.decode_step(params, cache,
                                      {"tokens": toks[:, t:t + 1]})
        worst = max(worst, held(step[:, 0], full[:, t], DECODE_TOL,
                                f"{label} decode step {t} vs forward")[0])
    log(f"{label} decode vs forward: {LM_DECODE} steps, B={LM_B}, float32 "
        f"cache: max_abs_err {worst!r} (limit {DECODE_TOL})")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def lm_serving(argv, label):
    """Serve through the launcher's entry function (its own seeded
    weights), launch counts read around it (decode runs no kernel): every
    request must complete with ``max_new`` tokens and the cache stay
    finite. Then one warm wave's time and device time, and the peak."""
    import gc
    import torch
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    args = serve_mod.parse_args(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    stats, batcher = serve_mod.serve(args)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = dict(common.LAUNCHES)
    log(f"{label} serving {' '.join(argv)}: {json.dumps(stats)}")
    if stats["completed"] != args.requests or \
            stats["tokens_out"] != args.requests * args.max_new:
        raise AssertionError(f"{label} serving: {stats['completed']} of "
                             f"{args.requests} requests, "
                             f"{stats['tokens_out']} tokens")
    if not all(bool(torch.isfinite(x).all()) for x in _leaves(batcher.cache)):
        raise AssertionError(f"{label} serving: the cache is not finite")

    def wave():
        return batcher.model.decode_step(batcher.params, batcher.cache,
                                         {"tokens": batcher._tokens})

    with torch.no_grad():
        wave_ms = cuda_ms(wave, reps=10)
        log(f"{label} decode wave device time: " + json.dumps(
            device_breakdown(wave)))
    log(f"{label} serving: {serve_s:.3f} s for {stats['steps']} waves "
        f"({serve_s / stats['steps'] * 1e3:.3f} ms per wave with weight "
        f"init and admission), warm decode wave (B={args.wave_slots}) "
        f"{wave_ms!r} ms, launches {serve_launches}")
    del batcher, wave
    gc.collect()
    torch.cuda.empty_cache()
    peak_line(f"{label} serving")


def lm_phase(dev):
    """Serve recurrentgemma-2b at full width: prefill through
    ``LMModel.prefill`` with the kernels (launch counts read around it),
    the kernels against their plain versions at the prefill's own inputs
    and on edge cases, prefill logits against the plain path, decode
    against forward, the serving launcher's entry function, and the
    kernels' times. Returns the kernels' records."""
    import gc
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_chunked
    from repro_torch.kernels.rglru_scan.ops import linear_scan
    from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models.lm import LMModel

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    arch = get_arch(LM_ARCH)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    plan = model.plan
    n_attn = plan["n_super"] * plan["pattern"].count("local_attn") + \
        plan["tail"].count("local_attn")
    n_rglru = arch.n_layers - n_attn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = param_count(model.schema())
    log(f"LM: {LM_ARCH} at full width ({arch.n_layers} layers, d_model "
        f"{arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads x "
        f"{arch.resolved_head_dim}, window {arch.hybrid.window}, vocab "
        f"{arch.vocab_size}): {n_params} fp32 parameters "
        f"({n_params * 4 / 2**30:.3f} GiB) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s, seed {SEED}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(1, arch.vocab_size, (LM_B, LM_S), device=dev,
                           dtype=torch.int32, generator=gen)
    batch = {"tokens": tokens}

    # the main path: one prefill, launch counts read around it
    fa_calls, scan_calls = [], []
    with torch.no_grad(), capture(attn_mod, "flash_attention", fa_calls), \
            capture(rglru_mod, "linear_scan", scan_calls):
        torch.cuda.synchronize()
        common.reset_launches()                 # just before the path
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)        # just after it
    first_s = time.perf_counter() - t0
    log(f"LM prefill B={LM_B} S={LM_S}: first run {first_s:.3f} s, "
        f"launches {launches}")
    if (launches["flash_attention"], launches["rglru_scan"]) != (n_attn,
                                                                n_rglru):
        raise AssertionError(f"prefill launched flash_attention "
                             f"{launches['flash_attention']} and rglru_scan "
                             f"{launches['rglru_scan']} times, want "
                             f"{n_attn} and {n_rglru}")
    if logits.shape != (LM_B, 1, model.padded.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")

    # each kernel against its plain version at the prefill's own inputs
    (q, k, v), fa_kw = fa_calls[0][0], fa_calls[0][1]
    a, b = scan_calls[0][0][:2]
    a, b = a.float().contiguous(), b.float().contiguous()
    del fa_calls[1:], scan_calls[1:]
    with torch.no_grad():
        _, fa_err = check_attention(q, k, v, "prefill inputs (layer 3)",
                                    window=fa_kw["window"],
                                    scale=fa_kw["scale"])
        scan_err = check_scan(a, b, "prefill inputs (layer 1)")
        lm_kernel_edges(dev)

        lm_prefill_checks(model, plain, params, batch, logits, "LM")
        lm_decode_vs_forward(arch, params, tokens, dev, "LM")

    # the kernels' times at the prefill shape
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    window, scale = fa_kw["window"], fa_kw["scale"]
    with torch.no_grad():
        fa_ms = cuda_ms(lambda: flash_attention(q, k, v, window=window,
                                                scale=scale, mode="cuda"),
                        reps=10)
        fa_plain = cuda_ms(lambda: attention_chunked(q, k, v, window=window,
                                                     scale=scale), reps=2)
        pos = torch.arange(Sq, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
        sdpa_err = float((sdpa.transpose(1, 2) - attention_chunked(
            q, k, v, window=window, scale=scale)).abs().max())
        del sdpa
        fa_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True),
            reps=3)
        pairs = attention_pairs(Sq, Skv, 0, window) * B * Hq
        fa_bound, fa_by = bound_ms(4 * (2 * B * Sq * Hq * D
                                        + 2 * B * Skv * Hkv * D),
                                   4.0 * D * pairs)
        sc_ms = cuda_ms(lambda: linear_scan(a, b, mode="cuda"), reps=20)
        sc_device = device_ms(lambda: linear_scan(a, b, mode="cuda"),
                              reps=20)
        sc_plain = cuda_ms(lambda: linear_scan_sequential(a, b), reps=2)
        sc_bound, sc_by = bound_ms(3 * 4 * a.numel(), 2.0 * a.numel())
    fa_time = dict(shape=f"prefill local attention: q ({B}, {Sq}, {Hq}, "
                   f"{D}), k/v ({B}, {Skv}, {Hkv}, {D}) f32, window "
                   f"{window}; {pairs} visible pairs", ms=fa_ms,
                   plain_ms=fa_plain, bound_ms=fa_bound, bound_by=fa_by,
                   library_ms=fa_lib, library_max_abs_err=sdpa_err)
    sc_time = dict(shape=f"prefill RG-LRU scan: a/b {tuple(a.shape)} f32",
                   ms=sc_ms, device_ms=sc_device, plain_ms=sc_plain,
                   bound_ms=sc_bound, bound_by=sc_by, library_ms=None)
    log(f"flash_attention timing {json.dumps(fa_time)}")
    log(f"rglru_scan timing {json.dumps(sc_time)}")
    del q, k, v, a, b, qt, kt, vt, mask, fa_calls, scan_calls
    del params, plain, model
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("LM prefill, kernels, decode vs forward")
    lm_serving(SERVE_ARGV, "LM")
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:89",
             launches=launches["flash_attention"], max_abs_err=fa_err,
             **fa_time),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan/kernel.py:52",
             launches=launches["rglru_scan"], max_abs_err=scan_err,
             **sc_time),
    ]


# ---------------------------------------------------------------------------
# phase 9: serving rwkv6-7b at full width (prefill + decode waves)
# ---------------------------------------------------------------------------
RWKV_ARCH = "rwkv6-7b"
RWKV_SERVE_ARGV = ["--arch", RWKV_ARCH, "--requests", "32", "--wave-slots",
                   "8", "--max-new", "16", "--seed", str(SEED)]
# The kernel takes its plain version's float32 operations in their order,
# so it should give the same bits; y and the final state are held within
# 1e-5 of their largest |value| and whether the bits are equal is printed.
# Logits and decode as for recurrentgemma-2b.
WKV_TOL = 1e-5


def check_wkv6(r, k, v, w, u, label):
    """Kernel (through the dispatching wrapper) vs plain version; the
    kernel's bits equal on two runs. Returns the largest absolute error."""
    import torch
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
    got = wkv6(r, k, v, w, u, mode="cuda")
    again = wkv6(r, k, v, w, u, mode="cuda")
    want = wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"wkv6 {label}: two runs differ")
    errs = []
    for part, g, x in zip(("y", "state"), got, want):
        if g.shape != x.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"wkv6 {label}: {part} has shape "
                                 f"{tuple(g.shape)} or is not finite")
        err, top = float((g - x).abs().max()), float(x.abs().max())
        if err > WKV_TOL * top:
            raise AssertionError(f"wkv6 {label}: {part} off by {err!r}, "
                                 f"over {WKV_TOL} of its largest |value| "
                                 f"{top!r}")
        errs.append(err)
        log(f"wkv6 {label}: {part} {tuple(g.shape)} max_abs_err {err!r} "
            f"(limit {WKV_TOL * top!r}), bit-equal {torch.equal(g, x)}")
    return max(errs)


def wkv6_edges(dev):
    """The kernel against its plain version off the prefill's shape: one
    step, a length that is no multiple of the chunk, the reduced model's
    head of 16, one batch and head, decays near 1 and near 0, and inputs
    that are strided views off 16-byte alignment."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for shape, w_lo, w_hi, label in [
            ((1, 1, 1, 64), 0.6, 0.99, "S 1, N 64, B = H = 1"),
            ((1, 4097, 1, 64), 0.9996, 0.9998, "S 4097, N 64, decay ~0.9997"),
            ((2, 4097, 4, 16), 0.0, 0.01, "S 4097, N 16, decay near 0"),
            ((1, 1, 1, 16), 0.6, 0.99, "S 1, N 16")]:
        r, k, v = (torch.randn(shape, device=dev, generator=gen) * 0.5
                   for _ in range(3))
        w = w_lo + (w_hi - w_lo) * torch.rand(shape, device=dev,
                                              generator=gen)
        u = torch.randn(shape[2:], device=dev, generator=gen) * 0.5
        check_wkv6(r, k, v, w, u, label)
    # heads cut from a wider activation at an offset of one float, with an
    # odd time stride: read in place with 4-byte copies
    B, S, H, N = 2, 300, 4, 64
    wide = [torch.randn((B, S, 2 * H * N + 1), device=dev, generator=gen)
            * 0.5 for _ in range(4)]
    wide[3] = torch.sigmoid(wide[3])
    r, k, v, w = (x[..., 1:1 + H * N].unflatten(-1, (H, N)) for x in wide)
    u = torch.randn((H, N), device=dev, generator=gen) * 0.5
    check_wkv6(r, k, v, w, u, "strided views off 16-byte alignment")


def rwkv_phase(dev):
    """Serve rwkv6-7b at full width: prefill through ``LMModel.prefill``
    with the kernel (launch counts read around it), the kernel against its
    plain version at the prefill's own inputs (layer 0) and on edge cases,
    prefill logits against the plain path, decode against forward, the
    serving launcher's entry function, and the kernel's times. Returns the
    kernel's record."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
    from repro_torch.kernels import common
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.lm import LMModel

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    arch = get_arch(RWKV_ARCH)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    n_layers = model.plan["n"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = param_count(model.schema())
    log(f"RWKV: {RWKV_ARCH} at full width ({arch.n_layers} layers, d_model "
        f"{arch.d_model}, {arch.d_model // arch.rwkv.head_size} heads x "
        f"{arch.rwkv.head_size}, d_ff {arch.d_ff}, vocab {arch.vocab_size}):"
        f" {n_params} fp32 parameters ({n_params * 4 / 2**30:.3f} GiB) "
        f"drawn on the card in {time.perf_counter() - t0:.3f} s, seed {SEED}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(1, arch.vocab_size, (LM_B, LM_S), device=dev,
                           dtype=torch.int32, generator=gen)
    batch = {"tokens": tokens}

    # the main path: one prefill, launch counts read around it
    calls = []
    with torch.no_grad(), capture(rwkv_mod, "wkv6", calls, keep=1):
        torch.cuda.synchronize()
        common.reset_launches()                 # just before the path
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)        # just after it
    log(f"RWKV prefill B={LM_B} S={LM_S}: first run "
        f"{time.perf_counter() - t0:.3f} s, launches {launches}")
    others = {n: c for n, c in launches.items() if n != "wkv6" and c}
    if launches["wkv6"] != n_layers or others:
        raise AssertionError(f"prefill launched wkv6 {launches['wkv6']} "
                             f"times (want {n_layers}) and {others}")
    if logits.shape != (LM_B, 1, model.padded.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")

    r, k, v, w, u = calls[0][0][:5]
    with torch.no_grad():
        wkv_err = check_wkv6(r, k, v, w, u, "prefill inputs (layer 0)")
        wkv6_edges(dev)

        lm_prefill_checks(model, plain, params, batch, logits, "RWKV")
        lm_decode_vs_forward(arch, params, tokens, dev, "RWKV")

        # the kernel's times at the prefill shape
        B, S, H, N = r.shape
        wkv_ms = cuda_ms(lambda: wkv6(r, k, v, w, u, mode="cuda"), reps=20)
        wkv_plain = cuda_ms(lambda: wkv6_ref(r, k, v, w, u), reps=2)
        wkv_bound, wkv_by = bound_ms(
            4 * (5 * B * S * H * N + H * N + B * H * N * N),
            B * S * H * (5.0 * N * N + 5.0 * N))
    wkv_time = dict(shape=f"prefill WKV6 (layer 0): r/k/v/w ({B}, {S}, {H}, "
                    f"{N}) f32, u ({H}, {N})", ms=wkv_ms,
                    plain_ms=wkv_plain, bound_ms=wkv_bound, bound_by=wkv_by,
                    library_ms=None)
    log(f"wkv6 timing {json.dumps(wkv_time)}")
    del r, k, v, w, u, calls, params, plain, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("RWKV prefill, kernel, decode vs forward")
    lm_serving(RWKV_SERVE_ARGV, "RWKV")
    return dict(name="wkv6", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan/kernel.py:61",
                launches=launches["wkv6"], max_abs_err=wkv_err, **wkv_time)


def peak_line(label: str) -> None:
    """Print the phase's peak device memory and reset the counter."""
    import torch
    torch.cuda.synchronize()
    log(f"peak memory [{label}]: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()


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

    no_work_build = start_no_work_build()
    seconds = build.build()
    no_work_lib = finish_no_work_build(no_work_build)
    log(f"build: {seconds:.3f} s for {sorted(build.SOURCES)} and "
        f"block_histograms' no-work build")
    for name in build.SOURCES:
        log(build.log_path(name).read_text().strip())

    t0 = time.perf_counter()
    data = tpch.generate(scale=SCALE, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rows = {t: next(iter(c.values())).shape[0] for t, c in data.tables.items()}
    log(f"data: SF{SCALE} seed {SEED} {rows} in "
        f"{time.perf_counter() - t0:.3f} s")

    peak_line("data")
    aggs, agg_errs, probe, probe_err = kernel_phase(data, dev)
    agg_times = {q: dict(time_hash_aggregate(*aggs[q], f"{q} at SF1"),
                         max_abs_err=agg_errs[q]) for q in ("q1", "q18")}
    probe_time = time_join_probe(probe[0], "q3 lineitem x orders at SF1")
    for q, t in agg_times.items():
        log(f"hash_aggregate timing {json.dumps(t)}")
    log(f"join_probe timing {json.dumps(probe_time)}")

    peak_line("kernels vs plain, single device")
    results, launches, warm = main_path(data)
    oracle = oracle_f64(data.tables)
    check_results(results, oracle)
    for c, per_q in warm.items():
        log(f"warm ms per query [{c}]: {json.dumps(per_q)}")
    log("forced join kernel, warm ms: " + "; ".join(
        f"{q} kernel {warm['kernel'][q]!r} plain {warm['plain'][q]!r} "
        f"cost {warm['cost'][q]!r}" for q in ("q3", "q5")))
    peak_line("single-device main path")

    radix_call = radix_phase(data, dev)
    radix_time = time_block_histograms(
        *radix_call, f"q3 lineitem owners of one shard at SF1, "
        f"{N_SHARDS} shards", no_work_lib)
    log(f"block_histograms timing {json.dumps(radix_time)}")
    r2_phase(data)
    peak_line("block_histograms vs plain, R2")
    dist_launches, dist_warm, dist_peak, overflowed = dist_main_path(
        data, results["plain"], oracle)
    for c, per_q in dist_warm.items():
        log(f"warm ms per query [{c}]: {json.dumps(per_q)}")
    dist_agg = dist_aggregate_call(data)
    dist_agg_time = time_hash_aggregate(
        *dist_agg, f"largest call of one shard under composed/INTERLEAVE, "
        f"{N_SHARDS} shards, SF1")
    log(f"hash_aggregate distributed timing {json.dumps(dist_agg_time)}")
    peak_line(f"distributed path, {N_SHARDS} shards")
    tele_launches = telemetry_phase(data)
    peak_line("telemetry and tracing")
    del data, results
    wd = WData(dev)
    w_phase(wd, dev)
    peak_line("W1-W3")
    w_launches, w_agg_time, w_probe_time = w_local_phase(wd)
    del wd
    peak_line("W1-W4 one device")
    lm_kernels = lm_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    wkv_kernel = rwkv_phase(dev)

    head = agg_times["q18"]
    kernels = [
        dict(name="hash_aggregate_multi", route="cuda",
             source="src/repro_torch/kernels/csrc/hash_aggregate.cu",
             replaces="src/repro/kernels/hash_aggregate/kernel.py:54",
             launches=launches["hash_aggregate_multi"], **head,
             launches_distributed=dist_launches["hash_aggregate_multi"],
             launches_telemetry=tele_launches["hash_aggregate_multi"],
             launches_w_one_device=w_launches["hash_aggregate_multi"],
             other_shapes=[agg_times["q1"], dist_agg_time, w_agg_time]),
        dict(name="join_probe", route="cuda",
             source="src/repro_torch/kernels/csrc/join_probe.cu",
             replaces="src/repro/kernels/join_probe/kernel.py:40",
             launches=launches["join_probe"], max_abs_err=probe_err,
             launches_telemetry=tele_launches["join_probe"],
             launches_w_one_device=w_launches["join_probe"],
             **probe_time, other_shapes=[w_probe_time]),
        dict(name="block_histograms", route="cuda",
             source="src/repro_torch/kernels/csrc/radix_partition.cu",
             replaces="src/repro/kernels/radix_partition/kernel.py:35",
             launches=dist_launches["block_histograms"], max_abs_err=0.0,
             launches_telemetry=tele_launches["block_histograms"],
             **radix_time),
    ] + lm_kernels + [wkv_kernel]
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
