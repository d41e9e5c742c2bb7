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
  * the paper's axes: the 7 hand-written queries (``tpch.QUERIES``) at
    SF1 under ``xla`` and ``kernel``, held to the float64 evaluation and
    to ``run_query`` under the same executor, warm ms of both;
    ``hash_aggregate`` (the one-column wrapper) at q18's per-order call,
    bit for bit the one-column ``hash_aggregate_multi`` and within
    tolerance of its plain version; the host's NUMA nodes, distances and
    the card's node from sysfs, cross-checked with ``nvidia-smi topo
    -m`` (a machine that exposes neither is reported so); and Fig 2's
    allocator sweep (``memory.microbench.sweep``, 2000 ops a stream, 1-32
    streams), BUMP contending more than SLAB and ARENA at 8 streams;
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
  * the serving tier on the SF1 tables, through ``tpch.submit_query`` and
    ``AnalyticsService``: the 7 queries x 4 clients as whole plans under
    each thread placement, q1/q6 in morsels of 262,144 rows under the
    kernel executor, q3/q5/q18 as split probes, q3/q5 with the join
    kernel forced and q3/q18 on 8 shards, each against serial (the
    morsel merges against float64 and across placements);
    ``hash_aggregate_multi`` against its plain version at each shape of
    the served q1 and q6 morsels; pools x workers of 1x1 and 2x2 on the
    same 28 requests in 10 rounds each, the idle share and the overlap
    of the pools' streams; a chaos round; and
    ``scripts/trace_gate_torch.py`` on the card;
  * the planner's cost model fitted on the card: ``main`` of
    ``scripts/calibrate_costs_torch.py`` at SF1 sizes (the base fit over
    lineitem's rows, the group sweep to 131,072 groups, the join, Exchange
    and split-probe crossovers on 8 virtual shards and 2 x 2 pools), with
    its ``hash_aggregate_multi`` and ``block_histograms`` launches
    counted, the constants checked (finite, positive, the per-pass slope
    above its runs' spread) and a copy refreshed from telemetry; then the 7
    queries under ``cost`` on one device and on 8 shards x 4 policies
    under the builtin and the fitted profile: the decisions that differ,
    the fitted runs held to the gates above, bit-equal to the builtin's
    where the plan is unchanged, and warm ms of both (the ``calibration``
    line);
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
    and 32 requests served through the launcher;
  * training: the gradients of ``linear_scan``, ``flash_attention`` and
    ``wkv6`` with the kernels' forwards against plain autograd, at a
    small and at the full-width shape; recurrentgemma-2b at full width
    and depth (fp32 parameters, master weights and moments), batch 1 x
    4096 tokens, ``remat="block"``: one loss and backward with the
    kernels against the plain versions, then 3 steps through
    ``repro_torch.runtime.train_loop.train`` (16 ``flash_attention`` and
    52 ``rglru_scan`` launches a step; step 0 at lr 0 leaves the master
    weights' bits, step 1 moves them), with the step's time split into
    forward+backward and optimizer, tokens/s, peak memory and idle share;
    rwkv6-7b at full width cut to 2 layers, one loss and backward with
    the ``wkv6`` kernel against the plain forward; and the
    checkpoint/restart drill of reduced recurrentgemma-2b on the card;
  * the data-parallel step (``runtime.dp_step.make_dp_train_step``): (A)
    recurrentgemma-2b at full width and depth, 1 x 4096, over a
    torch.distributed group of one rank on NCCL (``core.dist``): one
    uncompressed DP step bit-equal to ``train_loop``'s step, then 3 steps
    with int8 gradient compression and error feedback (16
    ``flash_attention`` and 52 ``rglru_scan`` launches a step; every
    leaf's deq - target within half a block scale and its residual
    exactly target - q * scale in the first step; step and compression
    ms, the bytes each collective was handed, the peak); (B) the same
    width cut to 3 layers on a 4-rank virtual mesh, global batch 4 x
    1024, 3 steps: uncompressed DP against one rank on the whole batch
    (loss and parameters within 1e-5), kernels against plain versions,
    and the compressed step's synced gradients equal to the scheme's
    dequant(sum q_i / n, sum scale_i / n) of the ranks' own quantized
    values, the ranks' targets averaging to the uncompressed gradients,
    and within the scheme's bound of the uncompressed ones; (C)
    phi3.5-moe at full width, 2 layers, 1 x 4096, through
    ``LMModel(moe_mesh=VirtualMesh(8))`` against the same model on one
    device, under the flip rule;
  * phi3.5-moe at full width (d_model 4096, 16 experts top-2 of 6400),
    depth cut to 12 of 32 layers (15.9B fp32 parameters): one 2 x 4096
    prefill (12 ``flash_attention`` launches, expert ids and dropped
    assignments recorded per layer), the kernel against its plain version
    at the prefill's own q/k/v, logits against the plain path and 64
    decode steps against the forward (at capacity factor 8, where nothing
    drops) under the flip rule (a token the two paths route to other
    experts, and what it reaches, is not held; flips are printed), 32
    requests through ``launch.serve.serve`` with the cut config, the
    expert-parallel dispatch (``moe.moe_forward_sharded``) on 8 virtual
    shards against ``moe_forward`` on one layer, and one loss and
    backward at 2 layers;
  * qwen2-vl-2b (1,024 patch embeddings with 3-D M-RoPE positions and
    3,072 text tokens) and musicgen-large (frame embeddings, 4 codebook
    heads) at full width and depth: a 2 x 4096 prefill each (28 and 48
    ``flash_attention`` launches), the kernel at that prefill's inputs,
    logits against the plain path, 64 decode steps against the forward,
    and 8 musicgen requests served (its waves feed codes);
  * deepseek-v3 at full width (d_model 7168, 128 heads, MLA at q/k head
    dim 128 + 64, 256 experts top-8 of 2048 and a shared one), depth cut
    to its 3 dense layers and first MoE layer of 61, with the MTP head
    (15.80B fp32 parameters): one 2 x 4096 prefill at capacity factor
    1.25 (4 ``flash_attention`` launches at head dim 192, v zero-padded
    from 128), the kernel against its plain version at layer 0's q/k/v
    with SDPA on the padded and on the 128-wide v, logits against the
    plain path and 64 steps of the absorbed latent-cache decode against
    the forward (at capacity factor 32) under the flip rule, one forward
    ``loss_fn`` at 1 x 1024 (5 launches: the layers and the MTP head's)
    with ce, aux, mtp and total against the plain pass, and 8 requests
    through ``launch.serve.serve`` with the cut config;
  * the dry run (``launch/dryrun.py``) against the card, at float32
    parameters: recurrentgemma-2b's train step at full depth, 1 x 4096,
    its and rwkv6-7b's 2 x 4096 prefills, phi3.5-moe's prefill at 12
    layers and one recurrentgemma-2b decode step, each built and traced
    by ``build_cell`` and ``trace`` on fake tensors (no byte allocated, no
    launch) and then run on real arguments to the same specs: their
    bytes equal to the plan's ``argument_bytes_per_device``, their
    allocation within the allocator's slack, FLOPs equal to a FlopCounterMode around the
    real step, outputs' shapes and dtypes equal, the predicted peak above
    the arguments within 10% of the measured rise of
    ``max_memory_allocated``; and the script's depth cuts by
    ``run_cell``'s one-card ``fits``: phi3.5-moe's prefill fits at 12
    layers and not at 32, deepseek-v3 at 4 layers and 1 x 1024 fits its
    forward (a prefill) and not its train step;
  * the sharded step (the sharding plan applied through DTensor) over a
    one-rank NCCL mesh of shape (1, 1): (a) recurrentgemma-2b's train
    cell, 3 steps through the sharded step with sequence parallelism and
    ZeRO-1 state, losses and parameters bit for bit those of the
    unsharded steps, launches a step, ms a step and the peak; (b)
    rwkv6-7b at 2 layers, a prefill and a loss with its backward, bit
    for bit the unsharded route; each LM kernel reached through its
    sharding rule; (c) the dry run's trace of rank 0 of (a)'s cell, its
    step peak within 10% of (a)'s measured rise; (d) two ranks sharing
    the card, threads of this process, on a (data 1, model 2) and a
    (data 2, model 1) mesh:
    recurrentgemma-2b at 3 layers and rwkv6-7b at 2, full width, a loss
    with its gradients and a train step against the unsharded kernel
    route, every kernel launched on its rank's half of the block; (e)
    phi3.5-moe at full width, 2 layers, 1 x 4096, 3 train steps through
    the expert-parallel dispatch on the one-rank mesh, bit for bit the
    same steps through ``moe_mesh=VirtualMesh(1)``; (f) two ranks sharing
    the card on a (data 1, model 2) mesh, a real all-to-all between them:
    phi3.5-moe at 2 layers (8 experts a rank; a forward, a loss with its
    gradients and a train step) and deepseek-v3 at 4 layers (MLA, the
    shared expert, the MTP head; a forward and a forward ``loss_fn``), 1 x
    1024, against ``moe_mesh=VirtualMesh(2)`` under the routing-flip rule,
    flash launched on each rank's half of the heads at D 128 and D 192;
  * the host us a call of the three LM kernels, layer by layer (wrapper,
    checks and launch, ``torch.library`` operator, its implementation),
    and a recurrentgemma-2b decode wave's ms;
  * after every timed phase, the dry run's 16 x 16 and 2 x 16 x 16
    reports of three cells (rank 0's temporaries, ``fits``, collective
    bytes): predictions one card cannot check.

``python3 chip_smoke.py --host-cost SRC`` runs only that last timing, on
the port under SRC (a checkout's ``src``), and prints it as one
``host_cost`` JSON line and the card's line: run on two checkouts in
turns, it compares them on one card.

The kernel launch counts are zeroed just before each path and read just
after it; a kernel of a path that never launched fails the run. It also
checks that the plain path's float sums are the same bits on every run,
and prints the kernels' times beside their bounds, warm ms per query and
peak memory per phase. Any failed phase exits non-zero. Without a CUDA
device it exits 1 and prints no result. It imports nothing of JAX and
nothing of the JAX package.

The last lines of standard output are the sharded phase's, the dry
run's and the host cost's numbers, the MLA and MoE phases' numbers,
the training step's numbers, the DP phase's numbers, the calibration
report, the kernels' JSON
record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
    launches}, {name: microseconds a launch}) of one call of ``fn`` under
    torch.profiler, from ``PROFILER_SESSIONS`` sessions of ``reps`` calls
    each after one warm-up. Only the device's records are traced: nothing
    here reads the host's, and a call of tens of thousands of operations
    (a train step) then reads in seconds, where the host's records take a
    minute.

    On the card this runs on, a session now and then loses CUDA records
    of work that ran (all of them, or some of a kernel's) and now and
    then holds records of work that ran before it. ``fn`` runs the same
    work each call, so per record name the calls' launches are the median
    of the sessions' counts over ``reps``, rounded, and each launch takes
    the mean time of that name's records over all sessions. Sessions
    that disagree on their record counts are printed; a session that saw
    no device record at all lost its records and is run again (at most
    ``PROFILER_SESSIONS`` more times). Fewer than 2 sessions with
    records raise: one session alone is not read."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts, times, totals, lost = {}, {}, [], 0
    while (len(totals) < PROFILER_SESSIONS
           and lost < PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen, took = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.key] = e.count
                took[e.key] = getattr(e, "self_device_time_total", 0)
        if not seen:
            lost += 1
            continue
        for key, us in took.items():
            times[key] = times.get(key, 0.0) + us
        for key in set(counts) | set(seen):
            counts.setdefault(key, []).append(seen.get(key, 0))
        totals.append(sum(seen.values()))
    if len(set(totals)) > 1 or lost:
        log(f"torch.profiler: {len(totals)} sessions of {reps} calls saw "
            f"{totals} device records ({lost} more saw none)")
    if len(totals) < 2:
        raise RuntimeError(f"torch.profiler: {len(totals)} of "
                           f"{len(totals) + lost} sessions saw device work")
    per_call = {k: round(statistics.median(
        c + [0] * (len(totals) - len(c))) / reps)
        for k, c in counts.items()}
    per_call = {k: n for k, n in per_call.items() if n}
    if not per_call:
        raise RuntimeError("torch.profiler saw no device work")
    each = {k: times[k] / sum(counts[k]) for k in per_call}
    busy = sum(n * each[k] for k, n in per_call.items())
    return sum(per_call.values()), busy, per_call, each


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


def load_script(name: str):
    """The module of ``scripts/<name>.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@contextlib.contextmanager
def capture_largest(module, name: str, store: dict, kind, size):
    """Keep, for each ``kind(args, kwargs)``, the arguments of the call to
    ``module.name`` with the largest ``size(args, kwargs)``: a few
    distinct shapes of a run that makes many calls, without holding
    every call's tensors."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        k, n = kind(args, kwargs), size(args, kwargs)
        if k not in store or n > store[k][0]:
            store[k] = (n, args, kwargs)
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
    others = " and ".join(c for c in results if c != "plain")
    log(f"results: {others} give the plain path's integers; "
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
# phase 4b: the paper's axes: the hand-written queries, the one-column
# aggregate, the host's NUMA topology and the allocator sweep (Fig 2)
# ---------------------------------------------------------------------------
# the reference's executor-parity tolerance (tests/test_tpch_executors.py)
PARITY_ATOL, PARITY_RTOL = 1e-3, 1e-4
FIG2_OPS_PER_STREAM = 2000       # benchmarks/fig2_allocator_microbench.py


def imperative_queries(data, oracle):
    """The 7 hand-written queries under ``xla`` and ``kernel``: held to
    the float64 evaluation with check_results' gates, and to run_query
    under the same executor with the executor-parity tolerance (integers,
    counts, q3's keys and the overflow equal). Returns the kernel run's
    launches and warm ms of both paths."""
    import numpy as np
    import torch
    from repro_torch.analytics import planner
    from repro_torch.analytics.tpch import QUERIES, run_query
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    xla = {q: fn(data.tables, executor="xla") for q, fn in QUERIES.items()}
    torch.cuda.synchronize()
    common.reset_launches()                 # just before the kernel run
    kernel = {q: fn(data.tables, executor="kernel")
              for q, fn in QUERIES.items()}
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)        # just after it
    log(f"imperative queries: 7 x 2 executors in "
        f"{time.perf_counter() - t0:.3f} s (first runs), kernel run "
        f"launches {launches}")
    if launches["hash_aggregate_multi"] <= 0:
        raise AssertionError("the imperative kernel run never launched "
                             "hash_aggregate_multi")
    results = {"plain": xla, "kernel": kernel}
    check_results(results, oracle)
    warm = {}
    for executor, res in (("xla", xla), ("kernel", kernel)):
        ctx = planner.ExecutionContext(executor=executor)
        for q, fn in QUERIES.items():
            want = run_query(q, data, context=ctx)
            got = res[q]
            if set(got) != set(want):
                raise AssertionError(f"imperative {q}/{executor}: keys "
                                     f"{sorted(got)} != {sorted(want)}")
            for k, w in want.items():
                g = got[k]
                if k in EXACT_KEYS or not w.is_floating_point():
                    if not torch.equal(g, w):
                        raise AssertionError(f"imperative {q}/{executor}/{k}"
                                             ": differs from run_query")
                else:
                    np.testing.assert_allclose(
                        g.cpu().numpy(), w.cpu().numpy(), atol=PARITY_ATOL,
                        rtol=PARITY_RTOL,
                        err_msg=f"imperative {q}/{executor}/{k}")
            warm[f"{q}/{executor}"] = dict(
                imperative=cuda_ms(lambda fn=fn, e=executor: fn(
                    data.tables, executor=e), reps=WARM_REPS),
                run_query=cuda_ms(lambda q=q, ctx=ctx: run_query(
                    q, data, context=ctx), reps=WARM_REPS))
    log("imperative queries equal run_query under the same executor "
        f"(atol {PARITY_ATOL}, rtol {PARITY_RTOL}; integers exact)")
    return launches, warm


def check_wrapper(args, kw):
    """``hash_aggregate`` at q18's per-order call (its ids and the
    quantity column): bit for bit the one-column ``hash_aggregate_multi``,
    and within check_hash_aggregate's tolerance of the plain version;
    then timed there beside its bound, plain version and library call."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.hash_aggregate import (hash_aggregate,
                                                    hash_aggregate_multi)
    from repro_torch.kernels.hash_aggregate.ref import \
        hash_aggregate_multi_ref
    ids, n_bins = args[0], kw["n_bins"]
    col = args[1][..., -1].contiguous()
    before = common.LAUNCHES["hash_aggregate_multi"]
    got = hash_aggregate(ids, col, n_bins=n_bins)
    torch.cuda.synchronize()
    if common.LAUNCHES["hash_aggregate_multi"] != before + 1:
        raise AssertionError("hash_aggregate did not launch the kernel once")
    multi = hash_aggregate_multi(ids, col[..., None], n_bins=n_bins)[..., 0]
    if not torch.equal(got.view(torch.int32), multi.view(torch.int32)):
        raise AssertionError("hash_aggregate differs from the one-column "
                             "hash_aggregate_multi")
    plain = hash_aggregate_multi_ref(ids, col[..., None], n_bins=n_bins)
    scale = hash_aggregate_multi_ref(ids, col.abs()[..., None],
                                     n_bins=n_bins)
    err = (got - plain[..., 0]).abs()
    bad = err > 1e-4 * scale[..., 0] + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"hash_aggregate: {int(bad.sum())} sums off "
                             f"the plain version, max err {float(err.max())}")
    log(f"hash_aggregate (the wrapper) at q18's per-order call: ids "
        f"{tuple(ids.shape)} bins={n_bins} bit-equal to hash_aggregate_multi"
        f"(...)[..., 0], max_abs_err={float(err.max())} from the plain "
        "version")
    timing = dict(time_hash_aggregate(
        (ids, col[..., None]), dict(n_bins=n_bins), "hash_aggregate (the "
        "wrapper) at q18's ids and quantity column, SF1"),
        max_abs_err=float(err.max()))
    log(f"hash_aggregate wrapper timing {json.dumps(timing)}")
    return timing


def host_topology():
    """The host's NUMA nodes, distances and relative latencies from
    sysfs, the card's bus id and node, cross-checked with nvidia-smi topo
    -m where both name a node. A machine that exposes no NUMA directory
    (a container that hides it) is reported so, with what it does
    expose: nothing is assumed in its place."""
    import torch
    from repro_torch.core import topology
    props = torch.cuda.get_device_properties(0)
    out = dict(torch_pci=dict(domain=props.pci_domain_id,
                              bus=props.pci_bus_id,
                              device=props.pci_device_id),
               nvidia_smi_bus_id=topology.nvidia_smi_bus_id(0))
    with open("/proc/self/status") as f:
        out["mems_allowed_list"] = next(
            (ln.split(":", 1)[1].strip() for ln in f
             if ln.startswith("Mems_allowed_list")), None)
    out["cpus"] = sorted(os.sched_getaffinity(0))
    smi = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True, timeout=60)
    row = (topology.parse_nvidia_topo(smi.stdout) if smi.returncode == 0
           else None)
    out["nvidia_smi_topo"] = row or (smi.stdout + smi.stderr).strip()
    node_dir = os.path.join("/sys", *topology.NODE_DIR)
    if not os.path.isdir(node_dir):
        out["numa"] = f"not visible: this machine has no {node_dir}"
        log(f"host topology {json.dumps(out)}")
        return out
    out["numa"] = topology.read_host_topology(
        gpu_bus_id=out["nvidia_smi_bus_id"]).report()
    node, affinity = out["numa"]["gpu_node"], (row or {}).get("NUMA Affinity")
    if affinity and affinity.isdigit() and node is not None and node >= 0 \
            and int(affinity) != node:
        raise AssertionError(f"the card's node: sysfs {node}, nvidia-smi "
                             f"topo -m {affinity}")
    log(f"host topology {json.dumps(out)}")
    return out


def allocator_sweep():
    """``microbench.sweep`` at Fig 2's size; BUMP (one lock) must contend
    more than SLAB and ARENA at 8 streams, as the reference's test holds."""
    from repro_torch.memory.microbench import sweep
    rows = sweep(ops_per_stream=FIG2_OPS_PER_STREAM)
    for r in rows:
        log(f"fig2 {r.kind} streams={r.n_streams} ops/s={r.ops_per_sec!r} "
            f"contention_rate={r.contention_rate!r} "
            f"overhead_ratio={r.overhead_ratio!r}")
    at8 = {r.kind: r.contention_rate for r in rows if r.n_streams == 8}
    if not (at8["bump"] > at8["slab"] and at8["bump"] > at8["arena"]):
        raise AssertionError(f"contention at 8 streams out of order: {at8}")
    return [dict(kind=r.kind, n_streams=r.n_streams,
                 ops_per_sec=r.ops_per_sec, contention_rate=r.contention_rate,
                 overhead_ratio=r.overhead_ratio) for r in rows]


def paper_axes_phase(data, oracle, q18_call, card):
    """Phase 4b. Returns the imperative kernel run's launches and the
    wrapper's timing record."""
    t0 = time.perf_counter()
    launches, warm = imperative_queries(data, oracle)
    for key, ms in warm.items():
        log(f"imperative warm ms [{card}] {key}: {json.dumps(ms)}")
    wrapper = check_wrapper(*q18_call)
    host = host_topology()
    fig2 = allocator_sweep()
    seconds = time.perf_counter() - t0
    log("paper axes " + json.dumps(dict(card=card, seconds=seconds,
                                        host=host, fig2=fig2)))
    return launches, wrapper


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
    ops, busy_us, *_ = device_sessions(fn, 1)
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
# phase 6c: the serving tier at SF1 (analytics/service)
# ---------------------------------------------------------------------------
SERVE_MORSEL_ROWS = 262_144
SERVE_CLIENTS = 4
SERVE_ROUNDS = 10           # throughput rounds of each pool shape
# executor-parity tolerance of the morsel-merged sums against float64
SERVE_ATOL, SERVE_RTOL = 1e-3, 1e-4


def serve(config, requests, data):
    """Submit ``requests`` [(query, context)] to a fresh AnalyticsService,
    client i % SERVE_CLIENTS each, drain, and return ({index: value},
    ServiceStats). Every request must complete."""
    from repro_torch.analytics.service import AnalyticsService
    from repro_torch.analytics.tpch import submit_query
    with AnalyticsService(config) as svc:
        rids = [submit_query(svc, q, data, context=ctx,
                             client_id=i % SERVE_CLIENTS)
                for i, (q, ctx) in enumerate(requests)]
        results = svc.drain()
        st = svc.stats()
    bad = [(requests[i][0], results[r].error) for i, r in enumerate(rids)
           if results[r].value is None]
    if bad:
        raise AssertionError(f"served requests failed: {bad}")
    return {i: results[r].value for i, r in enumerate(rids)}, st


def hold_bits(got, want, label):
    if not same_bits(got, want):
        raise AssertionError(f"{label}: the served bits differ from "
                             "serial")


def hold_oracle(got, exact, oracle, label):
    """Morsel-merged results: integers and counts equal to the plain
    path's, float sums within the executor-parity tolerance of float64."""
    import numpy as np
    import torch
    for k, v in got.items():
        v = v.cpu()
        if k in EXACT_KEYS or not v.is_floating_point():
            if not torch.equal(v, exact[k].cpu()):
                raise AssertionError(f"{label}/{k}: differs from the plain "
                                     "path")
        elif k in oracle:
            want = oracle[k].cpu().numpy()
            g = v.to(torch.float64).numpy()
            if not np.allclose(g, want, atol=SERVE_ATOL, rtol=SERVE_RTOL):
                raise AssertionError(
                    f"{label}/{k}: off float64 by "
                    f"{float(np.max(np.abs(g - want)))} (atol {SERVE_ATOL}, "
                    f"rtol {SERVE_RTOL})")
        elif not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}/{k}: not finite")


def kernel_intervals(trace_path):
    """{stream: sorted [(start us, end us)]} of the CUDA kernels in a
    torch.profiler Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            s = e.get("args", {}).get("stream", e.get("tid"))
            out.setdefault(s, []).append((float(e["ts"]),
                                          float(e["ts"]) + float(e["dur"])))
    return {s: sorted(v) for s, v in out.items()}


def overlap(a, b):
    """(pairs of kernels of ``a`` and ``b`` that overlap in time, their
    summed overlap in us); each list's kernels are disjoint and sorted."""
    import bisect
    starts = [s for s, _ in b]
    ends = [e for _, e in b]
    pairs, us = 0, 0.0
    for s, e in a:
        lo = bisect.bisect_right(ends, s)
        hi = bisect.bisect_left(starts, e)
        for j in range(lo, hi):
            pairs += 1
            us += min(e, b[j][1]) - max(s, b[j][0])
    return pairs, us


def union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def serve_profiled(config, requests, data):
    """Kernel intervals by stream of one served round under one
    torch.profiler session (the trace names streams by the profiler's
    ids, not by the handles PyTorch gives)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(tempfile.mkdtemp(prefix="serve_trace_"),
                        "round.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(config, requests, data)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return kernel_intervals(path)


def service_phase(data, results, oracle):
    """The serving tier on the SF1 tables: whole plans under the three
    placements, distributive morsels, split probes, the forced join kernel
    and the 8-shard composed context through ``tpch.submit_query`` and
    ``AnalyticsService``, each against serial; then throughput, idle share
    and pool-stream overlap, a chaos round and the trace gate. Returns
    (the kernels' launches in the served paths, the first q1 morsel's
    hash_aggregate_multi call, its max abs error against the plain
    version)."""
    import statistics
    import torch
    from repro_torch.analytics import columnar, planner
    from repro_torch.analytics.service import (AnalyticsService,
                                               RetryPolicy, ServiceConfig,
                                               ServiceFaultInjector,
                                               ThreadPlacement)
    from repro_torch.analytics.tpch import (LOGICAL_QUERIES, run_query,
                                            submit_query)
    from repro_torch.kernels import common

    t_phase = time.perf_counter()
    tables = data.tables
    cost = planner.ExecutionContext(executor="cost")
    kernel = planner.ExecutionContext(executor="kernel")
    forced = planner.ExecutionContext(**CONTEXTS["kernel"])
    composed = dist_contexts()["composed/INTERLEAVE"]
    n_li = tables["lineitem"]["l_orderkey"].shape[0]
    n_ord = tables["orders"]["o_orderkey"].shape[0]
    per_scan = {"lineitem": -(-n_li // SERVE_MORSEL_ROWS),
                "orders": -(-n_ord // SERVE_MORSEL_ROWS)}
    dist_serial = {q: run_query(q, data, context=composed)
                   for q in ("q3", "q18")}
    pool = planner.join_index_pool()
    torch.cuda.synchronize()
    common.reset_launches()                 # just before the served paths

    # 1. whole plans: 7 queries x 4 clients under each placement
    mix = [(q, cost) for q in LOGICAL_QUERIES for _ in range(SERVE_CLIENTS)]
    for placement in ThreadPlacement:
        got, st = serve(ServiceConfig(n_pools=2, workers_per_pool=2,
                                      placement=placement), mix, data)
        for i, (q, _) in enumerate(mix):
            hold_bits(got[i], results["cost"][q], f"{q}/{placement.value}")
    log(f"service whole plans: {len(mix)} requests x {len(ThreadPlacement)} "
        f"placements bit-equal to serial ({st.dispatches} dispatches, "
        f"{st.dedup_hits} dedup hits a round)")

    # 2. distributive morsels under the kernel executor
    morsel = {}
    for placement in ThreadPlacement:
        got, st = serve(ServiceConfig(
            n_pools=2, workers_per_pool=2, morsel_rows=SERVE_MORSEL_ROWS,
            placement=placement), [("q1", kernel), ("q6", kernel)], data)
        if st.morsels != 2 * per_scan["lineitem"]:
            raise AssertionError(f"q1+q6 under {placement.value}: "
                                 f"{st.morsels} morsels, not "
                                 f"{2 * per_scan['lineitem']}")
        morsel[placement] = got
    for placement, got in morsel.items():
        for i, q in enumerate(("q1", "q6")):
            hold_bits(got[i], morsel[ThreadPlacement.DENSE][i],
                      f"{q} morsels under {placement.value} against DENSE")
            hold_oracle(got[i], results["plain"][q], oracle[q],
                        f"{q} morsels/{placement.value}")
    log(f"service morsels: q1/q6 in {per_scan['lineitem']} morsels of "
        f"{SERVE_MORSEL_ROWS} rows each, the same bits under every "
        f"placement, within atol {SERVE_ATOL} rtol {SERVE_RTOL} of float64")

    # 3. split probes, from an empty index pool. SPARSE stripes each
    # task's morsels over both pools and nothing is stolen, so each pool
    # probes every split build column and makes its replica of it
    split_q = ("q3", "q5", "q18")
    pool.clear()
    got, st = serve(ServiceConfig(n_pools=2, workers_per_pool=2,
                                  morsel_rows=SERVE_MORSEL_ROWS,
                                  placement=ThreadPlacement.SPARSE,
                                  steal=False),
                    [(q, cost) for q in split_q], data)
    for i, q in enumerate(split_q):
        hold_bits(got[i], results["cost"][q], f"{q} split probe")
    want = 2 * per_scan["lineitem"] + per_scan["orders"]
    if st.morsels != want:
        raise AssertionError(f"split probes: {st.morsels} morsels, not "
                             f"{want}")
    rows = planner._true_rows(tables)
    specs, required = set(), set()
    for q in split_q:
        split = planner.probe_split(planner.lower(LOGICAL_QUERIES[q], cost,
                                                  rows))
        specs |= {p.index for p in split.preludes if p.index is not None}
        required |= set(planner.required_indexes(LOGICAL_QUERIES[q].root))
    if pool.replicas != 2 * len(specs) or pool.builds != len(required):
        raise AssertionError(f"join index pool: {pool.replicas} replicas "
                             f"and {pool.builds} builds for {sorted(specs)} "
                             f"split of {sorted(required)}")
    log(f"service split probes: q3/q5/q18 bit-equal to serial in {want} "
        f"morsels; {pool.replicas} replicas (2 pools x {sorted(specs)}), "
        f"{pool.builds} sorts")

    # 4. forced join kernel, whole plans; 5. 8 shards, composed context
    got, _ = serve(ServiceConfig(n_pools=2, workers_per_pool=2),
                   [("q3", forced), ("q5", forced), ("q3", composed),
                    ("q18", composed)], data)
    hold_bits(got[0], results["kernel"]["q3"], "q3 forced join kernel")
    hold_bits(got[1], results["kernel"]["q5"], "q5 forced join kernel")
    hold_bits(got[2], dist_serial["q3"], "q3 composed, 8 shards")
    hold_bits(got[3], dist_serial["q18"], "q18 composed, 8 shards")
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)        # just after the served paths
    log(f"service forced join kernel and {N_SHARDS} shards: bit-equal to "
        f"serial; launches in the served paths {launches}")
    for name in ("hash_aggregate_multi", "join_probe", "block_histograms"):
        if launches[name] <= 0:
            raise AssertionError(f"the served paths never launched {name}")
    peak_line("service paths")

    # the served morsels' aggregate calls against the plain version, one
    # check per distinct shape of q1's and q6's (a scan's last morsel is
    # shorter); q1's first morsel call is timed for the kernel record
    morsel_call, morsel_err = None, None
    for q in ("q1", "q6"):
        calls, seen = [], set()
        with capture(columnar, "hash_aggregate_multi", calls):
            serve(ServiceConfig(n_pools=1, workers_per_pool=1,
                                morsel_rows=SERVE_MORSEL_ROWS),
                  [(q, kernel)], data)
        if not calls:
            raise AssertionError(f"a served {q} morsel never called "
                                 "hash_aggregate_multi")
        for args, kw in calls:
            key = (tuple(args[0].shape), args[1].shape[2], kw["n_bins"])
            if key in seen:
                continue
            seen.add(key)
            err = check_hash_aggregate(args[0], args[1], kw["n_bins"],
                                       f"one served {q} morsel")
            if morsel_call is None:
                morsel_call, morsel_err = (args, kw), err

    # 6. throughput of 1 pool x 1 worker against 2 pools x 2 workers on
    # the same 28 requests, one dispatch each (no dedup), in alternating
    # rounds; the idle share and the streams' overlap from one profiled
    # 2 x 2 round, its busy time over its own wall
    card = card_line()
    shapes = {"1x1": (1, 1), "2x2": (2, 2)}
    rounds = {label: [] for label in shapes}
    for _ in range(SERVE_ROUNDS):
        for label, (n_pools, workers) in shapes.items():
            cfg = ServiceConfig(n_pools=n_pools, workers_per_pool=workers,
                                batching=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = serve(cfg, mix, data)
            torch.cuda.synchronize()
            rounds[label].append((len(mix) / (time.perf_counter() - t0),
                                  st.latency_p50_ms, st.latency_p99_ms))
    rates = {}
    for label, rs in rounds.items():
        rates[label] = {
            key: dict(median=statistics.median(col),
                      quartiles=statistics.quantiles(col, n=4)[::2],
                      min=min(col), max=max(col))
            for key, col in zip(("qps", "p50_ms", "p99_ms"), zip(*rs))}
        rates[label]["qps"]["rounds"] = [r[0] for r in rs]
    faster = sum(a[0] > b[0] for a, b in zip(rounds["1x1"], rounds["2x2"]))
    t0 = time.perf_counter()
    intervals = serve_profiled(
        ServiceConfig(n_pools=2, workers_per_pool=2, batching=False), mix,
        data)
    wall = time.perf_counter() - t0
    busy = union_us([iv for v in intervals.values() for iv in v]) / 1e6
    # the pools' two streams run the round's kernels: the two busiest
    by_count = sorted(intervals, key=lambda k: -len(intervals[k]))
    if len(by_count) < 2:
        raise AssertionError(f"a 2-pool round ran kernels on streams "
                             f"{by_count} only")
    a, b = intervals[by_count[0]], intervals[by_count[1]]
    pairs, both_us = overlap(a, b)
    others = {k: len(intervals[k]) for k in by_count[2:]}
    log(f"service throughput over {SERVE_ROUNDS} rounds of {len(mix)} "
        f"requests each [{card}]: {json.dumps(rates)}; 1x1 served more "
        f"queries/s than the 2x2 round after it in {faster} of "
        f"{SERVE_ROUNDS} pairs")
    log(f"service profiled 2x2 round [{card}]: device busy "
        f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall under the "
        f"profiler (idle share {1 - busy / wall:.4f}); the two pool streams "
        f"ran {len(a)} and {len(b)} kernels, {pairs} pairs of them overlap "
        f"in time for {both_us / 1e3:.3f} ms; kernels on other streams "
        f"{others}")

    # 7. chaos round: a build failure, a wait poison, a pool killed with
    # morsels queued, a straggling pool (device work), two waves
    clean, _ = serve(ServiceConfig(n_pools=2, workers_per_pool=2,
                                   morsel_rows=SERVE_MORSEL_ROWS),
                     [("q1", cost), ("q6", cost)], data)
    refs = {q: results["cost"][q] for q in LOGICAL_QUERIES}
    refs.update(q1=clean[0], q6=clean[1])
    faults = ServiceFaultInjector(seed=3, kill_pool_at=(0, 1),
                                  build_fail_at={1}, poison_wait_at={3},
                                  straggle_pool=(2, 0.02))
    cfg = ServiceConfig(n_pools=3, workers_per_pool=2,
                        morsel_rows=SERVE_MORSEL_ROWS,
                        placement=ThreadPlacement.SPARSE, faults=faults,
                        retry=RetryPolicy(max_attempts=3,
                                          base_backoff_s=0.005,
                                          max_backoff_s=0.05))
    with AnalyticsService(cfg) as svc:
        rids, results_c = [], {}
        for _ in range(2):
            rids += [(q, submit_query(svc, q, data, context=cost))
                     for q in LOGICAL_QUERIES]
            results_c.update(svc.drain())
        st = svc.stats()
        ewma = svc.scheduler.stats().pool_ewma_s
    if sorted(results_c) != sorted(r for _, r in rids):
        raise AssertionError("chaos round: not one result per request")
    for q, r in rids:
        res = results_c[r]
        states = [res.value is not None, res.error is not None, res.expired,
                  res.shed]
        if sum(states) != 1 or res.value is None:
            raise AssertionError(f"chaos round {q}: terminal states {states}"
                                 f" ({res.error})")
        hold_bits(res.value, refs[q], f"chaos round {q}")
    fired = (faults.builds_failed, faults.waits_poisoned, faults.pools_killed)
    if fired != (1, 1, 1) or st.requeued <= 0 or st.dead_pools != (1,):
        raise AssertionError(f"chaos round: faults fired {fired}, requeued "
                             f"{st.requeued}, dead pools {st.dead_pools}")
    log(f"service chaos round: {len(rids)} requests, one terminal result "
        f"each, all bit-equal; {st.describe()}; requeued {st.requeued}, "
        f"quarantined {st.quarantined_pools}, pool EWMA s {ewma}")

    # 8. the trace gate's five contracts on the card
    if load_script("trace_gate_torch").main([]) != 0:
        raise AssertionError("trace gate failed on the card")
    peak_line("service phase")
    log(f"service phase: {time.perf_counter() - t_phase:.3f} s")
    return launches, morsel_call, morsel_err


# ---------------------------------------------------------------------------
# phase 6d: the planner's cost model fitted on the card, and the SF1 paths
# under the fitted profile
# ---------------------------------------------------------------------------
CALIB_COLS = (1, 2, 3, 4, 6)
CALIB_GROUPS = tuple(512 << i for i in range(9))                # ... 131072
CALIB_DIST_BUILDS = tuple(1 << b for b in range(10, 21, 2))     # ... 2^20
CALIB_EXCHANGE_BUILD = 1 << 17                    # ~ customer at SF1
CALIB_EXCHANGE_PROBES = tuple(1 << b for b in range(16, 24))    # ... 2^23
CALIB_MORSEL_PROBES = tuple(1 << b for b in range(12, 23, 2))   # ... 2^22
FITTED = ("fused_fixed", "fused_per_col", "sort_pass_factor",
          "dense_group_limit", "partition_capacity_factor",
          "dist_route_factor", "radix_route_factor", "morsel_split_rows")
# entries of raw_us that count rows or name a choice, not microseconds
NOT_TIMES = ("overflow_at_cf", "cost_picks", "moved_rows")


def raw_times(node, path="raw_us"):
    """(path, value) of every timing in a profile's raw_us."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k not in NOT_TIMES:
                yield from raw_times(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from raw_times(v, f"{path}/{i}")
    else:
        yield path, node


def check_profile(prof) -> dict:
    """Fail unless every fitted constant is finite and positive, every
    timing is positive, the per-pass slope exceeds the spread (distance
    between quartiles) of the runs of each baseline point (a slope inside
    the noise prices nothing), and no single width sets the slope: the
    least-squares slope of t_xla(C), which the fit takes as the pass, is
    within a factor of 1.5 of the median of the slopes between every two
    widths, which one bent point cannot move (a slow gather at one width
    would otherwise become the unit of every constant). Returns the
    largest spread and both slopes."""
    import itertools
    import math
    import numpy as np
    for k in FITTED:
        v = prof.get(k)
        if not isinstance(v, (int, float)) or not math.isfinite(v) or v <= 0:
            raise AssertionError(f"calibration: {k} = {v!r}")
    for path, v in raw_times(prof["raw_us"]):
        if not isinstance(v, (int, float)) or not v > 0:
            raise AssertionError(f"calibration: {path} = {v!r}")
    spread = max(r[3 * len(r) // 4] - r[len(r) // 4]
                 for r in prof["raw_us"]["xla_runs"].values())
    if not prof["pass_time_us"] > spread:
        raise AssertionError(
            f"calibration: the per-pass slope {prof['pass_time_us']} us is "
            f"inside the spread {spread} us of its own runs")
    xla = {int(c): t for c, t in prof["raw_us"]["xla"].items()}
    cols = sorted(xla)
    slope = float(np.polyfit(cols, [xla[c] for c in cols], 1)[0])
    robust = float(np.median([(xla[b] - xla[a]) / (b - a) for a, b in
                              itertools.combinations(cols, 2)]))
    if not slope / 1.5 <= robust <= slope * 1.5:
        raise AssertionError(
            f"calibration: the per-pass slope {slope:.1f} us rests on one "
            f"width: the median slope between widths is {robust:.1f} us "
            f"(t_xla {prof['raw_us']['xla']})")
    return {"spread_us": spread, "slope_us": round(slope, 1),
            "median_pair_slope_us": round(robust, 1)}


def calibration_phase(data, plain, oracle):
    """Fit the cost profile on the card through
    ``scripts/calibrate_costs_torch.py`` at SF1 sizes, refresh a copy of
    it from telemetry, then run the 7 queries under ``cost`` on one device
    and on 8 shards under each policy with the builtin and the fitted
    profile (``sf1_under_profile``). Returns (the fit's kernel launches,
    the report)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.analytics import columnar, engine, planner
    from repro_torch.kernels import common

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calib = load_script("calibrate_costs_torch")
    rows = data.tables["lineitem"]["l_orderkey"].shape[0]
    argv = (["--rows", str(rows), "--groups", "512",
             "--cols", *map(str, CALIB_COLS),
             "--sweep-groups", "--groups-sweep", *map(str, CALIB_GROUPS),
             "--dist", "--dist-devices", str(N_SHARDS),
             "--dist-probe", str(rows),
             "--dist-builds", *map(str, CALIB_DIST_BUILDS),
             "--exchange", "--exchange-build", str(CALIB_EXCHANGE_BUILD),
             "--exchange-probes", *map(str, CALIB_EXCHANGE_PROBES),
             "--morsel", "--morsel-probes", *map(str, CALIB_MORSEL_PROBES)])
    report = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cost_profile.json")
            aggs, hists = {}, {}
            torch.cuda.synchronize()
            common.reset_launches()           # just before the fit
            t0 = time.perf_counter()
            with capture_largest(
                    columnar, "hash_aggregate_multi", aggs,
                    kind=lambda a, kw: ("dense" if a[0].shape[0] <= 8
                                        else "partitioned", a[1].shape[2]),
                    size=lambda a, kw: kw["n_bins"] * a[0].numel()), \
                    capture_largest(
                        engine, "block_histograms", hists,
                        kind=lambda a, kw: (kw["n_bins"], kw["block"]),
                        size=lambda a, kw: a[0].numel()):
                if calib.main(argv + ["--out", path]) != 0:
                    raise AssertionError("calibrate_costs_torch failed")
            torch.cuda.synchronize()
            launches = dict(common.LAUNCHES)  # just after it
            fit_s = time.perf_counter() - t0
            log(f"calibration: fit in {fit_s:.3f} s, launches {launches}")
            for name in ("hash_aggregate_multi", "block_histograms"):
                if launches[name] <= 0:
                    raise AssertionError(f"the calibration never launched "
                                         f"{name}")
            # the fit's own shapes against the plain versions, outside
            # the count: per layout and width the call with the most
            # bins x rows, and the largest radix Exchange
            checked = []
            for (layout, C), (_n, a, kw) in sorted(aggs.items()):
                err = check_hash_aggregate(a[0], a[1], kw["n_bins"],
                                           f"calibration {layout} C={C}")
                checked.append(dict(kernel="hash_aggregate_multi",
                                    layout=layout, ids=list(a[0].shape),
                                    C=C, n_bins=kw["n_bins"],
                                    max_abs_err=err))
            for (n_bins, block), (_n, a, kw) in sorted(hists.items()):
                check_block_histograms(a[0], n_bins, kw["shift"], block,
                                       "calibration radix Exchange")
                checked.append(dict(kernel="block_histograms",
                                    keys=a[0].shape[0], n_bins=n_bins,
                                    block=block, max_abs_err=0))
                log(f"block_histograms calibration radix Exchange: keys "
                    f"{a[0].shape[0]}, {n_bins} bins, block {block}: equal")
            del aggs, hists
            with open(path) as f:
                fitted_raw = json.load(f)
            unit = check_profile(fitted_raw)
            log(f"calibration: per-pass slope {fitted_raw['pass_time_us']} "
                f"us over a largest quartile spread of {unit['spread_us']} "
                f"us, median slope between widths "
                f"{unit['median_pair_slope_us']} us, attempts at the "
                f"baseline {fitted_raw['base_attempts']}; "
                "constants " + json.dumps(
                    {k: fitted_raw[k] for k in FITTED}))
            fitted = planner.load_cost_profile(path)
            planner.set_cost_profile(None)
            # the telemetry loop on a copy: the SF1 runs take the fit
            refreshed = os.path.join(tmp, "refreshed.json")
            shutil.copyfile(path, refreshed)
            if calib.main(["--refresh", refreshed]) != 0:
                raise AssertionError("calibrate_costs_torch --refresh failed")
            with open(refreshed) as f:
                refreshed_raw = json.load(f)
            drifted = {k: [fitted_raw.get(k), v]
                       for k, v in refreshed_raw.items()
                       if k != "refreshed_from" and fitted_raw.get(k) != v}
            log(f"calibration: refresh drifted {drifted or 'no entry'}")
        report.update(profile=fitted_raw, refresh_drifted=drifted,
                      fit_s=round(fit_s, 3), launches=launches,
                      pass_unit=unit, kernel_checks=checked)
        report.update(sf1_under_profile(data, plain, oracle, fitted))
    finally:
        planner.set_cost_profile(None)
    if planner.current_cost_profile() != planner.CostProfile():
        raise AssertionError("the builtin cost profile is not back")
    torch.cuda.synchronize()
    report["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    report["phase_s"] = round(time.perf_counter() - t_phase, 3)
    peak_line("calibration phase")
    log(f"calibration phase: {report['phase_s']} s")
    return launches, report


def sf1_under_profile(data, plain, oracle, fitted):
    """The 7 queries under ``cost`` on one device and on 8 shards x the
    four policies, lowered, run and timed warm under the builtin profile
    and under ``fitted``: the decisions that differ printed, the fitted
    runs held to the gates, bit-equal to the builtin's where the physical
    plan is unchanged."""
    import dataclasses
    import torch
    from repro_torch.analytics import planner
    from repro_torch.analytics.tpch import LOGICAL_QUERIES, run_query
    from repro_torch.core.config import PlacementPolicy

    ctxs = {"cost/1": planner.ExecutionContext(executor="cost")}
    for pol in POLICIES:
        ctxs[f"cost/{N_SHARDS}/{pol}"] = planner.ExecutionContext(
            n_shards=N_SHARDS, policy=PlacementPolicy[pol])
    tables = data.tables
    decided, phys, out, warm = {}, {}, {}, {}
    for tag, profile in (("builtin", None), ("fitted", fitted)):
        planner.set_cost_profile(profile)
        t0 = time.perf_counter()
        for c, ctx in ctxs.items():
            for q, plan in LOGICAL_QUERIES.items():
                decided[tag, c, q] = {
                    (d.node, d.detail, d.choice)
                    for d in planner.explain(plan, tables, ctx)}
                phys[tag, c, q] = planner.compile_plan(plan, tables,
                                                       ctx).physical
                out[tag, c, q] = run_query(q, data, context=ctx)
        torch.cuda.synchronize()
        log(f"calibration: 7 queries x {len(ctxs)} contexts under the "
            f"{tag} profile in {time.perf_counter() - t0:.3f} s")
        for c, ctx in ctxs.items():
            for q in LOGICAL_QUERIES:
                warm[tag, c, q] = cuda_ms(
                    lambda q=q, ctx=ctx: run_query(q, data, context=ctx),
                    reps=WARM_REPS, warmup=0)
    lines, flips, same_plan = [], [], 0
    worst = [0.0, ""]
    planner.set_cost_profile(fitted)
    for c, ctx in ctxs.items():
        for q in LOGICAL_QUERIES:
            label = f"fitted/{c}/{q}"
            old, new = decided["builtin", c, q], decided["fitted", c, q]
            for sign, a, b in (("-", old, new), ("+", new, old)):
                lines += [f"{c} {q} {sign} {node}[{detail}] -> {choice}"
                          for node, detail, choice in sorted(a - b)]
            # a flip: the same node and inputs, another choice
            was = {(n, d): ch for n, d, ch in old}
            for n, d, ch in sorted(new):
                if was.get((n, d), ch) != ch:
                    flips.append(f"{c} {q} {n}[{d}]: {was[n, d]} -> {ch}")
            got = out["fitted", c, q]
            if "_overflow" in got and int(got["_overflow"]) != 0:
                log(f"overflow stated: {q} under {c}, fitted profile: "
                    f"{int(got['_overflow'])} records; re-run at "
                    f"{RETRY_CAPACITY}")
                got = run_query(q, data, context=dataclasses.replace(
                    ctx, capacity_factor=RETRY_CAPACITY))
                if int(got["_overflow"]) != 0:
                    raise AssertionError(f"{label}: overflow at capacity "
                                         f"{RETRY_CAPACITY}")
            check_against_plain(label, got, plain[q], oracle, 1e-5, worst)
            if phys["builtin", c, q] == phys["fitted", c, q]:
                same_plan += 1
                if not same_bits(out["fitted", c, q],
                                 out["builtin", c, q]):
                    raise AssertionError(f"{label}: the plan is unchanged "
                                         "but the bits differ from the "
                                         "builtin profile's")
    planner.set_cost_profile(None)
    for line in lines:
        log(f"calibration decision: {line}")
    for line in flips:
        log(f"calibration flip: {line}")
    pairs = {c: {q: [warm["builtin", c, q], warm["fitted", c, q]]
                 for q in LOGICAL_QUERIES} for c in ctxs}
    for c, per_q in pairs.items():
        log(f"calibration warm ms [builtin, fitted] [{c}]: "
            f"{json.dumps(per_q)}")
    log(f"calibration: {len(ctxs) * len(LOGICAL_QUERIES)} query runs under "
        f"the fitted profile hold the gates (largest deviation from "
        f"float64 {worst[0]!r}, {worst[1]}); {same_plan} with an unchanged "
        "plan are bit-equal to the builtin profile's; "
        f"{len(lines)} decision lines differ, {len(flips)} of them "
        "choices flipped on the same inputs")
    return dict(flips=flips, decision_lines_differ=len(lines),
                warm_ms=pairs, unchanged_plans=same_plan)


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


def kernel_kind(name: str) -> str:
    """The kind of a CUDA record's name: one of the LM kernels, a matrix
    product, or other."""
    name = name.lower()
    return ("flash_attention" if "fa_fwd" in name else
            "rglru_scan" if "scan_" in name else
            "wkv6" if "wkv6" in name else
            "matmul" if any(w in name for w in ("gemm", "cutlass", "xmma",
                                                "sm90")) else
            "other")


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
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + getattr(
            e, "self_device_time_total", 0) / 1e3
    busy = sum(kinds.values())
    return dict(wall_ms=wall, device_busy_ms=busy or "not measured",
                idle_share=(1 - busy / wall) if busy else "not measured",
                device_ops=ops, device_ms_by_kind=kinds)


# The routing-flip rule's ceiling (an MoE model): two paths whose round-off
# differs may route a token whose k-th and (k+1)-th expert probabilities
# nearly tie to other experts, which changes it, and what follows it, by
# O(1). A check holds the positions no flip reaches (``flip_reach``); it
# fails beyond MAX_FLIPS flips, or when a sequence is held at fewer than
# MIN_HELD of its positions.
MAX_FLIPS, MIN_HELD = 2, 0.5


def expert_ids(x, router, k):
    """Each token's top-k expert ids, ascending, from the layer's input
    and router (x (..., d) -> (..., k))."""
    import torch
    from repro_torch.models import moe as moe_mod
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    return moe_mod.top_k(probs, k)[1].sort(dim=-1).values


@contextlib.contextmanager
def record_routing(store, keep_input=False):
    """Wrap ``moe.moe_forward`` (here, never in the package) to record,
    for each call, the tokens' expert ids (B, S, k) recomputed from the
    layer's input and router, the capacity and the assignments the call
    drops (and, with ``keep_input``, the first call's input)."""
    import torch
    from repro_torch.models import moe as moe_mod
    orig = moe_mod.moe_forward

    def wrapper(p, x, arch, *, capacity=None):
        m = arch.moe
        T = x.shape[0] * x.shape[1]
        C = capacity or moe_mod._capacity(T, m)
        with torch.no_grad():
            ids = expert_ids(x, p["router"], m.top_k)
            counts = torch.bincount(ids.reshape(-1), minlength=m.n_experts)
            dropped = int(torch.clamp(counts - C, min=0).sum())
        rec = dict(ids=ids, capacity=C, dropped=dropped)
        if keep_input and not store:
            rec["x"] = x.detach().clone()
        store.append(rec)
        return orig(p, x, arch, capacity=capacity)

    moe_mod.moe_forward = wrapper
    try:
        yield
    finally:
        moe_mod.moe_forward = orig


def routing_flips(a, b):
    """(layer, sequence, position) of every token that two recorded runs
    of the same layers route to other experts."""
    import torch
    flips = []
    for layer, (ra, rb) in enumerate(zip(a, b)):
        diff = (ra["ids"] != rb["ids"]).any(dim=-1)
        flips += [(layer, s, t) for s, t in torch.nonzero(diff).tolist()]
    return sorted(flips, key=lambda f: (f[1], f[2], f[0]))


def flip_reach(flips, dropped, B, S):
    """(B, S) bool: the positions of the last layer's output that a
    routing flip can reach. ``flips`` are ``routing_flips``' (MoE layer,
    sequence, position), the MoE layers in execution order, ``dropped``
    each layer's dropped assignments (either path's). A flipped token
    changes by O(1) in its layer. In a layer that drops assignments it
    moves other tokens' drops too: every later token of the batch's flat
    order (the dispatch's order). In one that drops nothing the other
    tokens' rows and K-sums are the same computations, so only the token
    itself; then, through the attention of the layers after it (an MoE
    layer but the last), the later positions of its sequence."""
    import torch
    reach = torch.zeros(B * S, dtype=torch.bool)
    for layer, s, t in flips:
        if dropped[layer]:
            reach[s * S + t:] = True
        elif layer < len(dropped) - 1:
            reach[s * S + t:(s + 1) * S] = True
        else:
            reach[s * S + t] = True
    return reach.view(B, S)


def held_shares(reach):
    """Per sequence, the share of positions no flip reaches."""
    return [float((~r).float().mean()) for r in reach]


def held_unreached(got, want, reach, label):
    """``held`` at PREFILL_TOL over one sequence's (S, d) last-layer
    output of two passes, at the positions ``reach`` (S,) leaves out."""
    keep = ~reach.to(got.device)
    return held(got[keep], want[keep], PREFILL_TOL, label)


def flip_gate(flips, shares, label):
    """Raise beyond MAX_FLIPS routing flips, or when a share of positions
    held (one per sequence, or the share of tokens kept) is below
    MIN_HELD."""
    if len(flips) > MAX_FLIPS or min(shares) < MIN_HELD:
        raise AssertionError(f"{label}: {len(flips)} routing flips (at most "
                             f"{MAX_FLIPS}) {flips[:20]}, share of positions "
                             f"held {shares} (at least {MIN_HELD} each)")


def prefill_main_path(model, params, batch, label, want, spies):
    """The main path: one prefill, launch counts read around it, the first
    call of each (module, name) in ``spies`` captured. Raises unless the
    kernels launched are ``want`` ({kernel: launches}) and the logits have
    the last-token shape. Run under torch.no_grad(). Returns (logits,
    launches, [the captured call of each spy])."""
    import torch
    from repro_torch.kernels import common
    stores = [[] for _ in spies]
    with contextlib.ExitStack() as stack:
        for (module, name), store in zip(spies, stores):
            stack.enter_context(capture(module, name, store, keep=1))
        torch.cuda.synchronize()
        common.reset_launches()                 # just before the path
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)        # just after it
    log(f"{label} prefill B={LM_B} S={LM_S}: first run "
        f"{time.perf_counter() - t0:.3f} s, launches {launches}")
    launched = {n: c for n, c in launches.items() if c}
    if launched != want:
        raise AssertionError(f"{label} prefill launched {launched}, want "
                             f"{want}")
    codebooks = (model.arch.n_codebooks,) if model.arch.n_codebooks else ()
    if logits.shape != (LM_B, 1) + codebooks + (model.padded.vocab_size,):
        raise AssertionError(f"{label} prefill logits shape "
                             f"{tuple(logits.shape)}")
    return logits, launches, [store[0] for store in stores]


def attention_record(q, k, v, label, scale, window=None):
    """The flash kernel at a prefill's own (causal) inputs: against its
    plain version, its time, its plain version's, SDPA's (fp32,
    ``enable_gqa``, the window as a mask) and the bound. Returns the
    shape's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_chunked
    _, err = check_attention(q, k, v, label, window=window, scale=scale)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    ms = cuda_ms(lambda: flash_attention(q, k, v, window=window, scale=scale,
                                         mode="cuda"), reps=10)
    plain_ms = cuda_ms(lambda: attention_chunked(q, k, v, window=window,
                                                 scale=scale), reps=2)
    if window is None:
        mask_kw = dict(is_causal=True)
    else:
        pos = torch.arange(Sq, device=q.device)
        mask_kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                       & (pos[None, :] > pos[:, None] - window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                          enable_gqa=True, **mask_kw)
    sdpa_err = float((sdpa.transpose(1, 2) - attention_chunked(
        q, k, v, window=window, scale=scale)).abs().max())
    del sdpa
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=scale, enable_gqa=True, **mask_kw), reps=3)
    pairs = attention_pairs(Sq, Skv, 0, window) * B * Hq
    bound, by = bound_ms(4 * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D),
                         4.0 * D * pairs)
    rec = dict(shape=f"{label}: q ({B}, {Sq}, {Hq}, {D}), k/v ({B}, {Skv}, "
               f"{Hkv}, {D}) f32, causal, window {window}; {pairs} visible "
               f"pairs", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, library_ms=lib_ms,
               library_max_abs_err=sdpa_err)
    log(f"flash_attention timing {json.dumps(rec)}")
    return rec


def lm_prefill_checks(model, plain, params, batch, logits, label,
                      routed=None):
    """Prefill logits with the kernels against the plain versions'
    prefill, then the warm prefill's time, peak memory and device time by
    kind. With ``routed`` (an MoE model: the expert ids recorded in the
    kernels' prefill), under the flip rule: the last layer's output is
    held at the positions no routing flip reaches (``flip_reach``), and a
    sequence's last-token logits when no flip reaches its last position.
    Run under torch.no_grad(). Returns the prefill's numbers."""
    import torch
    B = logits.shape[0]
    numbers = {}
    reach, shares = None, [1.0] * B
    if routed is None:
        want, _ = plain.prefill(params, batch)
    else:
        plain_routed = []
        with record_routing(plain_routed):
            want_hidden, _ = plain._hidden(params, batch)
        want = plain._head(params, want_hidden[:, -1:])
        S = routed[0]["ids"].shape[1]
        flips = routing_flips(routed, plain_routed)
        dropped = [r["dropped"] for r in routed]
        reach = flip_reach(flips, [max(a, r["dropped"]) for a, r in zip(
            dropped, plain_routed)], B, S)
        shares = held_shares(reach)
        log(f"{label} prefill routing at capacity {routed[0]['capacity']} a "
            f"layer: dropped assignments per layer {dropped} (plain path "
            f"{[r['dropped'] for r in plain_routed]}); kernels vs plain: "
            f"{len(flips)} routing flips (layer, sequence, position) "
            f"{flips[:20]}")
        flip_gate(flips, shares, f"{label} prefill")
        got_hidden, _ = model._hidden(params, batch)
        for s in range(B):
            err, rel = held_unreached(got_hidden[s], want_hidden[s],
                                      reach[s], f"{label} prefill last "
                                      f"layer's output, sequence {s}")
            log(f"{label} prefill last layer's output, sequence {s}, kernels "
                f"vs plain: max_abs_err {err!r}, limit share {rel!r}, "
                f"positions held {shares[s]!r}")
        del got_hidden, want_hidden
        numbers.update(prefill_flips=flips, prefill_dropped_per_layer=dropped,
                       prefill_held_share=shares)
    for s in range(B):
        if reach is not None and bool(reach[s, -1]):
            log(f"{label} prefill logits, sequence {s}, not held: a routing "
                f"flip reaches its last position")
            continue
        err, rel = held(logits[s], want[s], PREFILL_TOL,
                        f"{label} prefill logits, sequence {s}")
        log(f"{label} prefill logits, sequence {s}, kernels vs plain: "
            f"max_abs_err {err!r}, limit share {rel!r}, positions held "
            f"{shares[s]!r} (|logit| up to {float(want[s].abs().max())!r})")
    del want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.prefill(params, batch), reps=WARM_REPS,
                 warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label} prefill warm: {ms!r} ms per prefill of {LM_B}x{LM_S} "
        f"tokens ({LM_B * LM_S / ms * 1e3:.1f} tokens/s), peak "
        f"{peak:.3f} GiB")
    breakdown = device_breakdown(lambda: model.prefill(params, batch))
    log(f"{label} prefill device time: " + json.dumps(breakdown))
    numbers.update(prefill_ms=ms, prefill_peak_gib=peak,
                   prefill_device=breakdown)
    return numbers


def decode_vs_forward(arch, params, seq, key, dev, label, routed=False):
    """LM_DECODE decode steps with a float32 cache against the forward
    pass over the same inputs: ``seq`` (B, S, ...) is the batch's ``key``
    ("tokens" or "embeds"), cut to LM_DECODE positions, and step t decodes
    its position t. With ``routed`` (an MoE model, run at its no-drop
    capacity) the steps no routing flip between the two reaches
    (``flip_reach``) are held. Run under torch.no_grad(). Returns the
    flips."""
    import torch
    from repro_torch.models.lm import LMModel
    m32 = LMModel(arch, device=dev, cache_dtype=torch.float32)
    fwd, dec = [], []
    with record_routing(fwd) if routed else contextlib.nullcontext():
        full, _, _ = m32.forward(params, {key: seq[:, :LM_DECODE]})
    cache = m32.init_cache(LM_B, LM_DECODE + 1)
    steps = []
    with record_routing(dec) if routed else contextlib.nullcontext():
        for t in range(LM_DECODE):
            step, cache = m32.decode_step(params, cache,
                                          {key: seq[:, t:t + 1]})
            steps.append(step[:, 0])
    flips = []
    reach = torch.zeros((LM_B, LM_DECODE), dtype=torch.bool)
    if routed:
        n = len(fwd)
        per_layer = [dict(ids=torch.cat([dec[t * n + i]["ids"]
                                         for t in range(LM_DECODE)], dim=1))
                     for i in range(n)]
        flips = routing_flips(fwd, per_layer)
        reach = flip_reach(flips, [r["dropped"] + sum(
            dec[t * n + i]["dropped"] for t in range(LM_DECODE))
            for i, r in enumerate(fwd)], LM_B, LM_DECODE)
        log(f"{label} decode vs forward at capacity factor "
            f"{arch.moe.capacity_factor} (no drops: forward capacity "
            f"{fwd[0]['capacity']}, dropped {sum(r['dropped'] for r in fwd)}"
            f"; decode {sum(r['dropped'] for r in dec)}): {len(flips)} "
            f"routing flips {flips[:20]}")
    shares = held_shares(reach)
    flip_gate(flips, shares, f"{label} decode vs forward")
    worst = 0.0
    for t in range(LM_DECODE):
        for s in range(LM_B):
            if not reach[s, t]:
                worst = max(worst, held(
                    steps[t][s], full[s, t], DECODE_TOL,
                    f"{label} decode step {t} sequence {s} vs forward")[0])
    log(f"{label} decode vs forward: {LM_DECODE} steps, B={LM_B}, float32 "
        f"cache: max_abs_err {worst!r} (limit {DECODE_TOL}), positions held "
        f"{shares}")
    return flips


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def lm_serving(argv, label, arch=None):
    """Serve through the launcher's entry function (its own seeded
    weights; ``arch``, a depth-cut config, in place of the named one),
    launch counts read around it (decode runs no kernel): every request
    must complete with ``max_new`` tokens and the cache stay finite. Then
    one warm wave's time and device time, and the peak. Returns the warm
    wave's ms and its device breakdown."""
    import gc
    import torch
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    args = serve_mod.parse_args(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    stats, batcher = serve_mod.serve(args, arch=arch)
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
                                         batcher._wave)

    with torch.no_grad():
        wave_ms = cuda_ms(wave, reps=10)
        wave_device = device_breakdown(wave)
        log(f"{label} decode wave device time: " + json.dumps(wave_device))
    log(f"{label} serving: {serve_s:.3f} s for {stats['steps']} waves "
        f"({serve_s / stats['steps'] * 1e3:.3f} ms per wave with weight "
        f"init and admission), warm decode wave (B={args.wave_slots}) "
        f"{wave_ms!r} ms, launches {serve_launches}")
    del batcher, wave
    gc.collect()
    torch.cuda.empty_cache()
    return wave_ms, wave_device, peak_line(f"{label} serving")


def lm_phase(dev):
    """Serve recurrentgemma-2b at full width: prefill through
    ``LMModel.prefill`` with the kernels (launch counts read around it),
    the kernels against their plain versions at the prefill's own inputs
    and on edge cases, prefill logits against the plain path, decode
    against forward, the serving launcher's entry function, and the
    kernels' times. Returns the kernels' records."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
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

    with torch.no_grad():
        logits, launches, (fa_call, scan_call) = prefill_main_path(
            model, params, batch, "LM",
            {"flash_attention": n_attn, "rglru_scan": n_rglru},
            [(attn_mod, "flash_attention"), (rglru_mod, "linear_scan")])

    # each kernel against its plain version at the prefill's own inputs,
    # with its times there
    (q, k, v), fa_kw = fa_call
    a, b = scan_call[0][:2]
    a, b = a.float().contiguous(), b.float().contiguous()
    del fa_call, scan_call
    with torch.no_grad():
        fa_rec = attention_record(q, k, v, f"{LM_ARCH} prefill (layer 3)",
                                  fa_kw["scale"], window=fa_kw["window"])
        del q, k, v
        scan_err = check_scan(a, b, "prefill inputs (layer 1)")
        lm_kernel_edges(dev)

        lm_prefill_checks(model, plain, params, batch, logits, "LM")
        decode_vs_forward(arch, params, tokens, "tokens", dev, "LM")

        sc_ms = cuda_ms(lambda: linear_scan(a, b, mode="cuda"), reps=20)
        sc_device = device_ms(lambda: linear_scan(a, b, mode="cuda"),
                              reps=20)
        sc_plain = cuda_ms(lambda: linear_scan_sequential(a, b), reps=2)
        sc_bound, sc_by = bound_ms(3 * 4 * a.numel(), 2.0 * a.numel())
    sc_time = dict(shape=f"prefill RG-LRU scan: a/b {tuple(a.shape)} f32",
                   ms=sc_ms, device_ms=sc_device, plain_ms=sc_plain,
                   bound_ms=sc_bound, bound_by=sc_by, library_ms=None)
    log(f"rglru_scan timing {json.dumps(sc_time)}")
    del a, b, params, plain, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("LM prefill, kernels, decode vs forward")
    lm_serving(SERVE_ARGV, "LM")
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:89",
             launches=launches["flash_attention"], **fa_rec),
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

    with torch.no_grad():
        logits, launches, (call,) = prefill_main_path(
            model, params, batch, "RWKV", {"wkv6": n_layers},
            [(rwkv_mod, "wkv6")])

    r, k, v, w, u = call[0][:5]
    with torch.no_grad():
        wkv_err = check_wkv6(r, k, v, w, u, "prefill inputs (layer 0)")
        wkv6_edges(dev)

        lm_prefill_checks(model, plain, params, batch, logits, "RWKV")
        decode_vs_forward(arch, params, tokens, "tokens", dev, "RWKV")

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
    del r, k, v, w, u, call, params, plain, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("RWKV prefill, kernel, decode vs forward")
    lm_serving(RWKV_SERVE_ARGV, "RWKV")
    return dict(name="wkv6", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan/kernel.py:61",
                launches=launches["wkv6"], max_abs_err=wkv_err, **wkv_time)


# ---------------------------------------------------------------------------
# phase 10: training on the card (recurrentgemma-2b at full width)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "recurrentgemma-2b"
# train_4k's sequence; its global batch of 256 is cut to 1 on one card
TRAIN_B, TRAIN_S = 1, 4096
TRAIN_STEPS, TRAIN_WARMUP = 3, 2          # the reference CLI's warmup
TRAIN_PEAK_GIB = 76.0                     # the card's 80 GB, less headroom
# kernels against plain versions over one loss and backward of 26 layers:
# the loss within 1e-4, the global grad norm within 1e-3 (relative)
TRAIN_LOSS_TOL, TRAIN_NORM_TOL = 1e-4, 1e-3
# the wrappers' grads against plain autograd, relative to the largest
# |grad|: the scan 1e-5 (float32 sums in other orders), the attention
# 1e-4 (the chunked backward against the naive softmax's)
GRAD_SCAN_TOL, GRAD_FA_TOL = 1e-5, 1e-4
RWKV_TRAIN_LAYERS, RWKV_TRAIN_S = 2, 512  # of 32 layers; 1 x 512 tokens
FT_TOL = 1e-6                             # a restarted run's final loss


def grad_held(got, want, tol, label):
    """Raise unless max|got - want| <= tol * max|want| for each pair;
    returns the largest of those ratios."""
    import torch
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: grad {i} has shape "
                                 f"{tuple(g.shape)} or is not finite")
        rel = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        if not rel <= tol:
            raise AssertionError(f"{label}: grad {i} off by {rel!r} of its "
                                 f"largest |value|, over {tol}")
        worst = max(worst, rel)
    return worst


def wrapper_grads(dev):
    """Gradients of the three wrappers with the kernels' forwards against
    plain autograd, at a small shape and at the full-width one; then the
    backward passes' pieces timed at the full shapes. Returns the timings
    and the largest relative errors."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_chunked_bwd, attention_chunked_with_lse, attention_naive)
    from repro_torch.kernels.rglru_scan.ops import linear_scan
    from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def launched(name, fn):
        before = common.LAUNCHES[name]
        out = fn()
        return out, common.LAUNCHES[name] - before

    errs = {}
    for shape, label in [((2, 257, 130), "small"),
                         ((1, 4096, 2560), "full width")]:
        a = (torch.rand(shape, device=dev, generator=gen) * 0.5
             + 0.499).requires_grad_()
        b, g = rnd(*shape).requires_grad_(), rnd(*shape)
        got, n = launched("rglru_scan", lambda: torch.autograd.grad(
            linear_scan(a, b, mode="cuda"), (a, b), g))
        want = torch.autograd.grad(linear_scan_sequential(a, b), (a, b), g)
        if n != 2:
            raise AssertionError(f"linear_scan grads launched the scan {n} "
                                 "times, want 2 (forward, reversed)")
        errs[f"rglru_scan {label}"] = grad_held(
            got, want, GRAD_SCAN_TOL, f"linear_scan grads {label}")
    scan_in = (a.detach(), b.detach(), g)
    for (B, S, Hq, Hkv, D, window), label in [
            ((1, 300, 4, 1, 64, 128), "small"),
            ((1, 4096, 10, 1, 256, 2048), "full width")]:
        ins = [rnd(B, S, h, D).requires_grad_() for h in (Hq, Hkv, Hkv)]
        g = rnd(B, S, Hq, D)
        got, n = launched("flash_attention", lambda: torch.autograd.grad(
            flash_attention(*ins, window=window, mode="cuda"), ins, g))
        if n != 1:
            raise AssertionError(f"flash_attention grads launched the "
                                 f"kernel {n} times, want 1 (the forward)")
        # the backward is plain code: the kernel's forward does not enter
        # it, so the plain forward's grads are the same bits
        plain = torch.autograd.grad(flash_attention(
            *ins, window=window, mode="ref"), ins, g)
        if not all(torch.equal(x, y) for x, y in zip(got, plain)):
            raise AssertionError("flash_attention: the kernel's forward "
                                 "changed the backward's bits")
        want = torch.autograd.grad(attention_naive(*ins, window=window),
                                   ins, g)
        errs[f"flash_attention {label}"] = grad_held(
            got, want, GRAD_FA_TOL, f"flash_attention grads {label}")
        del want, plain
    fa_in = ([x.detach() for x in ins], g, window)
    for shape, label in [((1, 64, 4, 64), "small"),
                         ((1, 512, 64, 64), "full width")]:
        ins = [(rnd(*shape) * 0.5).requires_grad_() for _ in range(3)]
        ins.append((0.6 + 0.39 * torch.rand(shape, device=dev,
                                            generator=gen)).requires_grad_())
        ins.append((rnd(*shape[2:]) * 0.5).requires_grad_())
        gy, gs = rnd(*shape), rnd(shape[0], shape[2], shape[3], shape[3])
        got, n = launched("wkv6", lambda: torch.autograd.grad(
            wkv6(*ins, mode="cuda"), ins, (gy, gs)))
        want = torch.autograd.grad(wkv6_ref(*ins), ins, (gy, gs))
        if n != 1 or not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"wkv6 grads {label}: {n} launches, or not "
                                 "the bits of autograd through wkv6_ref")
        errs[f"wkv6 {label}"] = 0.0
    log(f"wrapper grads against plain autograd (relative to the largest "
        f"|grad|; wkv6 bit-equal): {json.dumps(errs)}")

    # the backward passes' pieces at the full shapes
    a, b, g = scan_in
    a_rev = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1).flip(1)
    g_rev = g.flip(1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: linear_scan(a, b, mode="cuda"), reps=20)
        rev_ms = cuda_ms(lambda: linear_scan(a_rev, g_rev, mode="cuda"),
                         reps=20)
    a.requires_grad_(), b.requires_grad_()
    h = linear_scan(a, b, mode="cuda")
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(h, (a, b), g,
                                                 retain_graph=True), reps=10)
    (q, k, v), g, window = fa_in
    with torch.no_grad():
        lse_ms = cuda_ms(lambda: attention_chunked_with_lse(
            q, k, v, window=window), reps=3)
        out, lse = attention_chunked_with_lse(q, k, v, window=window)
        fa_bwd_ms = cuda_ms(lambda: attention_chunked_bwd(
            q, k, v, out, lse, g, window=window), reps=3)
    times = dict(
        rglru_scan=dict(shape=f"a, b {tuple(a.shape)} f32",
                        forward_ms=fwd_ms, reversed_ms=rev_ms,
                        op_backward_ms=bwd_ms),
        flash_attention=dict(
            shape=f"q {tuple(q.shape)}, k/v {tuple(k.shape)} f32, window "
                  f"{window}", plain_backward_ms=lse_ms + fa_bwd_ms,
            recompute_with_lse_ms=lse_ms, chunked_bwd_ms=fa_bwd_ms))
    log(f"backward timings: {json.dumps(times)}")
    return times, errs


def loss_and_grad_norm(model, params, batch, hidden):
    """One ``loss_fn`` and its backward: (loss, global grad norm), the
    grads freed; the last layer's output (the final norm's input) is
    appended to ``hidden``."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import _build, _flatten
    paths, leaves = zip(*((p, v.detach().requires_grad_())
                          for p, v in _flatten(params)))
    seen = []
    with capture(model, "_head", seen, keep=1):
        loss, _ = model.loss_fn(_build(list(paths), leaves), batch)
    hidden.append(seen[0][0][1].detach())
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            float(adamw.global_norm(dict(enumerate(grads)))))


def kernels_vs_plain_step(model, plain, params, batch, label, reach=None):
    """Step A: one loss and backward with the kernels and with the plain
    versions on the same params and batch; the loss and the global grad
    norm held within TRAIN_LOSS_TOL and TRAIN_NORM_TOL. Where the two
    passes route a token to other experts (an MoE model; ``reach``, the
    (1, S) positions of the batch's one sequence that a flip reaches,
    ``flip_reach``), the loss and norm cannot be held: the last layer's
    output is held at the other positions within PREFILL_TOL instead.
    Returns the kernels' launches in the kernels' pass."""
    from repro_torch.kernels import common
    before = dict(common.LAUNCHES)
    hidden = []
    t0 = time.perf_counter()
    k_loss, k_norm = loss_and_grad_norm(model, params, batch, hidden)
    k_s = time.perf_counter() - t0
    launched = {n: c - before[n] for n, c in common.LAUNCHES.items()
                if c != before[n]}
    t0 = time.perf_counter()
    p_loss, p_norm = loss_and_grad_norm(plain, params, batch, hidden)
    p_s = time.perf_counter() - t0
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    norm_rel = abs(k_norm - p_norm) / abs(p_norm)
    h_err = float((hidden[0] - hidden[1]).abs().max())
    log(f"{label} loss and backward, kernels vs plain: loss {k_loss!r} / "
        f"{p_loss!r} (rel {loss_rel!r}), grad norm {k_norm!r} / {p_norm!r} "
        f"(rel {norm_rel!r}), last layer's output max_abs_err {h_err!r} "
        f"(|value| up to {float(hidden[1].abs().max())!r}); {k_s:.3f} s / "
        f"{p_s:.3f} s; kernels' launches {launched}")
    if reach is not None:
        err, rel = held_unreached(hidden[0][0], hidden[1][0], reach[0],
                                  f"{label} last layer's output where no "
                                  f"routing flip reaches")
        log(f"{label}: routing flips: the last layer's output held where "
            f"none reaches, max_abs_err {err!r}, limit share {rel!r}, "
            f"positions held {held_shares(reach)[0]!r}; loss and grad norm "
            f"not held")
    elif not (loss_rel <= TRAIN_LOSS_TOL and norm_rel <= TRAIN_NORM_TOL):
        raise AssertionError(f"{label}: kernels and plain versions part: "
                             f"loss rel {loss_rel!r} (limit "
                             f"{TRAIN_LOSS_TOL}), grad norm rel "
                             f"{norm_rel!r} (limit {TRAIN_NORM_TOL})")
    return launched


@contextlib.contextmanager
def step_probe(train_loop):
    """Wrap the train loop's step and optimizer: CUDA events around each
    step and each update, launch counts per step, and the checks that
    step 0 (lr 0) leaves the master weights' bits and that step 1 moves
    every leaf whose grad is not zero. Step 1's check reads nothing back
    inside the step: its flags are read after the run."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.optim.adamw import leaves
    rec = dict(steps=[], updates=[], launches=[], checks=[], moved=None)
    make, update = train_loop.make_train_step, train_loop.adamw.update

    def fingerprints(tree):
        return [v.view(torch.int32).sum(dtype=torch.int64)
                for v in leaves(tree)]

    def probed_update(grads, state, params, lr, cfg):
        i = len(rec["updates"])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        snap = [v.cpu() for v in leaves(state.master)] if i == 0 else None
        marks = fingerprints(state.master) if i == 1 else None
        ev[0].record()
        out = update(grads, state, params, lr, cfg)
        ev[1].record()
        rec["updates"].append(ev)
        if snap is not None:
            same = all(torch.equal(v, s.to(v.device)) for v, s in
                       zip(leaves(out[1].master), snap))
            rec["checks"].append(("step 0 leaves the master bits", same))
            del snap
        if marks is not None:
            after = fingerprints(out[1].master)
            rec["moved"] = (torch.stack([a != b for a, b in
                                         zip(marks, after)]),
                            torch.stack([g.any() for g in leaves(grads)]))
        return out

    def probed_make(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def step(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            before = dict(common.LAUNCHES)
            ev[0].record()
            out = step_fn(*a, **k)
            ev[1].record()
            rec["steps"].append(ev)
            rec["launches"].append({n: c - before[n]
                                    for n, c in common.LAUNCHES.items()})
            return out
        return step

    train_loop.make_train_step = probed_make
    train_loop.adamw.update = probed_update
    try:
        yield rec
    finally:
        train_loop.make_train_step, train_loop.adamw.update = make, update
    moved, live = (x.tolist() for x in rec["moved"])
    rec["checks"].append((
        f"step 1 moves the params ({sum(moved)} of {len(moved)} leaves "
        f"moved, {sum(live)} have a grad)",
        all(m for m, g in zip(moved, live) if g) and any(moved)))


def train_launch_plan(plan):
    """{kernel: launches} of one loss and backward of a hybrid plan with
    remat="block": the checkpointed super-blocks run their kernels'
    forwards twice (the pass and the recompute), the unwrapped tail once;
    the scan's reversed pass once per RG-LRU layer."""
    pat = plan["pattern"]
    return {"flash_attention": plan["n_super"] * pat.count("local_attn") * 2
            + plan["tail"].count("local_attn"),
            "rglru_scan": plan["n_super"] * pat.count("rglru") * 3
            + plan["tail"].count("rglru") * 2}


def lm_train_phase(dev):
    """recurrentgemma-2b at full width and depth: step A (kernels against
    plain versions), step B (``train`` with the kernels, the main path,
    launch counts read around it), the step's timings, peak and idle
    share. Returns (launches per step, the record's numbers)."""
    import dataclasses
    import gc
    import math
    import statistics
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import LM_SHAPES, RunConfig, TrainConfig
    from repro_torch.core.params import param_count
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    marks = [("start", time.perf_counter())]
    arch = get_arch(TRAIN_ARCH)
    model = LMModel(arch, device=dev)              # remat="block"
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    want = train_launch_plan(model.plan)
    n_params = param_count(model.schema())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, TRAIN_B, TRAIN_S, step=0, seed=SEED).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(seed=SEED)
    log(f"train: {TRAIN_ARCH} at full width and depth ({arch.n_layers} "
        f"layers, d_model {arch.d_model}, vocab {arch.vocab_size}), "
        f"{n_params} fp32 parameters, fp32 master weights and moments; "
        f"batch {TRAIN_B} x seq {TRAIN_S} (train_4k's global batch 256 cut "
        f"to 1 on one card), remat {model.remat}")
    step_a = kernels_vs_plain_step(model, plain, params, batch,
                                   f"{TRAIN_ARCH} step A")
    if step_a != want:
        raise AssertionError(f"step A launched {step_a}, want {want}")
    del params, plain
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("train step A (kernels vs plain)")
    marks.append(("step A", time.perf_counter()))

    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(warmup_steps=TRAIN_WARMUP))
    with step_probe(train_loop) as rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()                 # just before the path
        t0 = time.perf_counter()
        res = train_loop.train(model, cfg, n_steps=TRAIN_STEPS,
                               batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)        # just after it
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in rec["steps"]]
    opt_ms = [a.elapsed_time(b) for a, b in rec["updates"]]
    log(f"train B: {json.dumps(dataclasses.asdict(res))}, {wall:.3f} s, "
        f"launches {launches}, per step {rec['launches']}, peak "
        f"{peak:.3f} GiB, step ms {step_ms}, optimizer ms {opt_ms}")
    for what, ok in rec["checks"]:
        log(f"train B: {what}: {ok}")
        if not ok:
            raise AssertionError(f"train B: {what}: failed")
    if len(rec["checks"]) != 2 or res.steps_run != TRAIN_STEPS or \
            not all(map(math.isfinite, res.losses)):
        raise AssertionError(f"train B: {res} ({len(rec['checks'])} checks)")
    for i, got in enumerate(rec["launches"]):
        if {n: got[n] for n in want} != want or got["wkv6"]:
            raise AssertionError(f"train step {i} launched {got}, want "
                                 f"{want}")
    launched = {n: rec["launches"][-1][n] for n in want}
    if peak >= TRAIN_PEAK_GIB:
        raise AssertionError(f"train B peak {peak:.3f} GiB reaches "
                             f"{TRAIN_PEAK_GIB}")
    warm = statistics.median(step_ms[1:])
    warm_opt = statistics.median(opt_ms[1:])
    losses = res.losses
    del res
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("train B", time.perf_counter()))

    # the device's busy time in one step (fresh state; 3 profiler sessions)
    # against the step's span on the stream (CUDA events above): the idle
    # share of a step
    params = model.init_params(seed=SEED)
    state = adamw.init(params, cfg.train)
    step_fn = train_loop.make_train_step(model, cfg, total_steps=TRAIN_STEPS)
    ops, busy_us, per_call, each = device_sessions(
        lambda: step_fn(params, state, batch, 2), 1)
    marks.append(("profiled step", time.perf_counter()))
    kinds = {}
    for name, n in per_call.items():
        kind = kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + n * each[name] / 1e3
    del params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    numbers = dict(step_ms=warm, forward_backward_ms=warm - warm_opt,
                   optimizer_ms=warm_opt,
                   tokens_per_s=TRAIN_B * TRAIN_S / warm * 1e3,
                   peak_gib=peak, device_busy_ms=busy_us / 1e3,
                   device_ops=ops, idle_share=1 - busy_us / 1e3 / warm,
                   device_ms_by_kind=kinds,
                   launches_per_step=launched, losses=losses)
    log(f"train step (median of steps 2-{TRAIN_STEPS}, CUDA events; busy "
        f"time from torch.profiler): {json.dumps(numbers)}")
    log(f"{TRAIN_ARCH} training, s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (_, prev), (name, t) in
        zip(marks, marks[1:])))
    peak_line("train B and the profiled step")
    return dict(launched), numbers


def rwkv_train_check(dev):
    """rwkv6-7b at full width, depth cut to RWKV_TRAIN_LAYERS: one loss and
    backward with the wkv6 kernel's forward against the plain forward.
    Returns the kernel's launches in that pass."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.lm import LMModel
    arch = dataclasses.replace(get_arch(RWKV_ARCH),
                               n_layers=RWKV_TRAIN_LAYERS)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    params = model.init_params(seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, 1, RWKV_TRAIN_S, step=0, seed=SEED).items()}
    log(f"train: {RWKV_ARCH} at full width (d_model {arch.d_model}, "
        f"{arch.d_model // arch.rwkv.head_size} heads of "
        f"{arch.rwkv.head_size}), depth cut to {RWKV_TRAIN_LAYERS} of 32 "
        f"layers, 1 x {RWKV_TRAIN_S} tokens")
    launched = kernels_vs_plain_step(model, plain, params, batch,
                                     f"{RWKV_ARCH} ({RWKV_TRAIN_LAYERS} "
                                     "layers)")
    if launched != {"wkv6": 2 * RWKV_TRAIN_LAYERS}:
        raise AssertionError(f"rwkv loss and backward launched {launched}")
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    peak_line(f"rwkv6-7b loss and backward, {RWKV_TRAIN_LAYERS} layers")
    return launched["wkv6"]


def ft_drill(dev):
    """The reference's FT drill on the card with reduced
    recurrentgemma-2b: 8 steps, a checkpoint every 2, a failure at step 5,
    against an uninterrupted run. The reduced head dim (16) is not one of
    the attention kernel's (64, 128, 192, 256), so the drill runs the plain
    versions."""
    import shutil
    import tempfile
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import LM_SHAPES, RunConfig, TrainConfig
    from repro_torch.models.lm import LMModel
    from repro_torch.runtime import FailureInjector, train
    arch = REDUCED[TRAIN_ARCH]
    model = LMModel(arch, device=dev, kernel_mode="ref")
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(warmup_steps=2))
    tmp = tempfile.mkdtemp(prefix="ft_drill_")
    try:
        t0 = time.perf_counter()
        res = train(model, cfg, n_steps=8, batch=2, seq=16, ckpt_dir=tmp,
                    ckpt_every=2, injector=FailureInjector(fail_at_steps=[5]))
        clean = train(model, cfg, n_steps=8, batch=2, seq=16)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = abs(res.final_loss - clean.final_loss) / abs(clean.final_loss)
    log(f"FT drill ({arch.name} reduced, 8 steps, checkpoint every 2, "
        f"failure at 5): restarts {res.restarts}, steps {res.steps_run}, "
        f"final loss {res.final_loss!r} vs uninterrupted "
        f"{clean.final_loss!r} (rel {rel!r}), {secs:.3f} s")
    if (res.restarts, res.steps_run) != (1, 8) or not rel <= FT_TOL:
        raise AssertionError(f"FT drill: {res} against {clean}")


def train_phase(dev):
    """Training on the card: the wrappers' gradients, recurrentgemma-2b's
    train steps, rwkv6-7b's gradient check, the FT drill. Returns
    ({kernel: launches per train step}, the backward timings, the step's
    numbers)."""
    import gc
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"train phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "allocated before it")
    times, errs = wrapper_grads(dev)
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("wrapper grads")
    marks = [time.perf_counter()]
    per_step, numbers = lm_train_phase(dev)
    marks.append(time.perf_counter())
    per_step["wkv6"] = rwkv_train_check(dev)
    marks.append(time.perf_counter())
    ft_drill(dev)
    marks.append(time.perf_counter())
    log(f"train phase: {marks[-1] - t0:.3f} s (wrapper grads "
        f"{marks[0] - t0:.3f}, recurrentgemma-2b {marks[1] - marks[0]:.3f}, "
        f"rwkv6-7b {marks[2] - marks[1]:.3f}, FT drill "
        f"{marks[3] - marks[2]:.3f})")
    return per_step, times, errs, numbers


# ---------------------------------------------------------------------------
# phase 10b: the data-parallel train step (runtime/dp_step.py)
# ---------------------------------------------------------------------------
# (A) recurrentgemma-2b at full width and depth, 1 x 4096 as phase 10, on
# a torch.distributed group of one rank over DP_BACKEND
DP_BACKEND = "nccl"
DP_STEPS = 3
DP_GROUP_TIMEOUT = 300.0                  # seconds, every collective
# (B) 4 ranks of a virtual mesh, full width cut to one super-block (3 of
# 26 layers: rglru, rglru, local_attn), global batch 4 x 1024; the
# uncompressed DP step against one rank on the whole batch: loss and
# parameters within 1e-5 (relative; the parameters' L2 distance)
DP_B_RANKS, DP_B_LAYERS, DP_B_BATCH, DP_B_S = 4, 3, 4, 1024
DP_B_TOL = 1e-5
# (C) phi3.5-moe at full width, 2 of 32 layers, 1 x 4096 tokens, through
# LMModel's moe_mesh on MOE_EP_SHARDS virtual shards at MOE_EP_FACTOR
DP_C_LAYERS, DP_C_S = 2, 4096


@contextlib.contextmanager
def dp_probe(check_steps=()):
    """Wrap ``compression.compress_leaf`` (here, never in the package):
    CUDA events around each call, summed per step (``rec["ms"]``, call
    ``rec["next_step"]()`` between steps), and in the steps of
    ``check_steps`` each leaf held on one rank: every element of
    deq - target within half its block's scale (plus the target's float32
    rounding), and the new residual exactly target - q * scale rounded
    once, chunk by chunk. Returns the record."""
    import torch
    from repro_torch.optim import compression
    orig = compression.compress_leaf
    rec = dict(step=0, events=[[]], leaves_held=0, worst_share=0.0)

    def held_leaf(target, q, scale, deq, resid, block):
        s = scale.repeat_interleave(block)[:target.numel()]
        t = target.reshape(-1)
        limit = s * (0.5 + 2.0 ** -15)
        share = float(((deq.reshape(-1).float() - t).abs() / limit).max())
        want = (t.double() - q[:t.numel()].double() * s.double()).float()
        if share > 1.0 or not torch.equal(resid.reshape(-1), want):
            raise AssertionError(
                f"compressed psum, leaf of {t.numel()} values: deq - target "
                f"reaches {share!r} of half a scale, or the residual is not "
                f"target - q * scale")
        rec["worst_share"] = max(rec["worst_share"], share)

    def probe(g, e, comm, block=256, out=None):
        check = rec["step"] in check_steps
        if check:
            g0, e0 = g.detach().clone(), e.clone()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = orig(g, e, comm, block, out)
        ev[1].record()
        rec["events"][-1].append(ev)
        if check:
            g0, d0 = (x.view(1) if x.dim() == 0 else x for x in (g0, res[0]))
            ef, rf = e0.view(-1), res[1].view(-1)
            row = ef.numel() // max(1, g0.shape[0])
            for r0, r1 in compression.row_chunks(g.shape, block):
                lo, hi = r0 * row, r1 * row
                target = g0[r0:r1].reshape(-1).float() + ef[lo:hi]
                q, scale = compression.quantize_int8(target, block)
                held_leaf(target, q, scale, d0[r0:r1].reshape(-1),
                          rf[lo:hi], block)
            rec["leaves_held"] += 1
            del g0, e0, d0
        return res

    def next_step():
        rec["step"] += 1
        rec["events"].append([])

    rec["next_step"] = next_step
    compression.compress_leaf = probe
    try:
        yield rec
    finally:
        compression.compress_leaf = orig
    rec["ms"] = [sum(a.elapsed_time(b) for a, b in evs)
                 for evs in rec["events"] if evs]


def traffic_delta(before, after):
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
            for k, v in after.items()}


def dp_main_path(dev):
    """(A): recurrentgemma-2b at full width and depth, 1 x 4096, through
    ``make_dp_train_step`` over a torch.distributed group of one rank on
    DP_BACKEND. An uncompressed DP step against ``train_loop``'s step on
    the same params and batch (the parameters bit for bit: the pmean of
    one rank is exact); then the main path, DP_STEPS compressed steps with
    the launch counts zeroed just before and read just after, each leaf's
    compression held in the first step (``dp_probe``), the peak under
    TRAIN_PEAK_GIB. Returns (launches per step, the record)."""
    import gc
    import math
    import statistics
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import dist as tdist
    from repro_torch.core.config import (LM_SHAPES, RunConfig,
                                         ShardingConfig, TrainConfig)
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import dp_step, train_loop
    arch = get_arch(TRAIN_ARCH)
    model = LMModel(arch, device=dev)
    want = train_launch_plan(model.plan)
    tcfg = TrainConfig(warmup_steps=TRAIN_WARMUP)
    cfg = {c: RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                        sharding=ShardingConfig(gradient_compression=c),
                        train=tcfg) for c in (False, True)}
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, TRAIN_B, TRAIN_S, step=s, seed=SEED).items()}
        for s in range(DP_STEPS)]
    log(f"dp (A): {TRAIN_ARCH} at full width and depth, batch {TRAIN_B} x "
        f"{TRAIN_S}, make_dp_train_step over torch.distributed, backend "
        f"{DP_BACKEND} (chosen here, not a fallback), world size 1, "
        f"group timeout {DP_GROUP_TIMEOUT} s")
    marks = [time.perf_counter()]
    store_dir = tempfile.mkdtemp(prefix="dp_store_")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    with tdist.process_group(DP_BACKEND, rank=0, world_size=1, store=store,
                             timeout=DP_GROUP_TIMEOUT) as mesh:
        log(f"dp (A): group up: backend {dist.get_backend()}, rank "
            f"{mesh.rank} of {mesh.n}")
        # the uncompressed DP step against train_loop's step, bit for bit
        params = model.init_params(seed=SEED)
        state = adamw.init(params, tcfg)
        train_loop.make_train_step(model, cfg[False], total_steps=DP_STEPS)(
            params, state, batches[1], 1)
        ref = [v.cpu() for v in leaves(params)]
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init_params(seed=SEED)
        state = adamw.init(params, tcfg)
        dp_step.make_dp_train_step(model, cfg[False], mesh,
                                   total_steps=DP_STEPS)(
            params, state, None, batches[1], 1)
        differ = sum(not torch.equal(v, r.to(dev))
                     for v, r in zip(leaves(params), ref))
        log(f"dp (A): one uncompressed DP step vs train_loop's step on the "
            f"same params and batch (step 1): {differ} of {len(ref)} "
            f"parameter leaves differ in any bit")
        if differ:
            raise AssertionError(f"dp (A): the uncompressed DP step parts "
                                 f"from train_loop's in {differ} leaves")
        del params, state, ref
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())

        # the main path: DP_STEPS compressed steps
        params = model.init_params(seed=SEED)
        state = adamw.init(params, tcfg)
        errors = dp_step.init_error_feedback(params, mesh)
        step_fn = dp_step.make_dp_train_step(model, cfg[True], mesh,
                                             total_steps=DP_STEPS)
        steps, per_step, traffic, losses = [], [], [], []
        with dp_probe(check_steps=(0,)) as rec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            common.reset_launches()             # just before the path
            for s in range(DP_STEPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                before = dict(common.LAUNCHES)
                t_before = {k: dict(v) for k, v in mesh.comm.traffic.items()}
                ev[0].record()
                params, state, errors, m = step_fn(params, state, errors,
                                                   batches[s], s)
                ev[1].record()
                steps.append(ev)
                per_step.append({n: c - before[n]
                                 for n, c in common.LAUNCHES.items()})
                traffic.append(traffic_delta(t_before, mesh.comm.traffic))
                losses.append(m["loss"])
                rec["next_step"]()
                if s == 0:      # step 0 holds the checks' copies of a leaf
                    torch.cuda.synchronize()
                    peak_checked = torch.cuda.max_memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            launches = dict(common.LAUNCHES)    # just after it
        peak = torch.cuda.max_memory_allocated() / 2**30
        marks.append(time.perf_counter())
    step_ms = [a.elapsed_time(b) for a, b in steps]
    losses = [float(x) for x in losses]
    n_params = sum(v.numel() for v in leaves(params))
    resid_norm = float(torch.sqrt(sum(e.double().square().sum()
                                      for e in leaves(errors))))
    del params, state, errors, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    for i, got in enumerate(per_step):
        if {n: got[n] for n in want} != want or got["wkv6"]:
            raise AssertionError(f"dp (A) step {i} launched {got}, want "
                                 f"{want}")
    total = {n: launches[n] for n in want}
    if total != {n: DP_STEPS * c for n, c in want.items()}:
        raise AssertionError(f"dp (A) launched {launches} in "
                             f"{DP_STEPS} steps, want {want} a step")
    if not all(map(math.isfinite, losses)) or \
            rec["leaves_held"] != len(list(leaves(model.schema()))):
        raise AssertionError(f"dp (A): losses {losses}, leaves held "
                             f"{rec['leaves_held']}")
    if max(peak, peak_checked) >= TRAIN_PEAK_GIB:
        raise AssertionError(f"dp (A) peak {peak:.3f} GiB ({peak_checked:.3f} "
                             f"in the checked step) reaches {TRAIN_PEAK_GIB}")
    values = n_params
    moved = traffic[-1]
    numbers = dict(
        backend=DP_BACKEND, world_size=1, parameters=n_params,
        step_ms=statistics.median(step_ms[1:]), step_ms_each=step_ms,
        compression_ms=statistics.median(rec["ms"][1:]),
        compression_ms_each=rec["ms"], losses=losses, peak_gib=peak,
        peak_gib_checked_step=peak_checked,
        tokens_per_s=TRAIN_B * TRAIN_S / statistics.median(step_ms[1:])
        * 1e3, launches_per_step={n: per_step[-1][n] for n in want},
        bytes_per_step=moved,
        bytes_per_value={k: v["bytes"] / values for k, v in moved.items()},
        bf16_psum_bytes_per_value=2.0, fp32_psum_bytes_per_value=4.0,
        worst_share_of_half_scale=rec["worst_share"],
        leaves_held=rec["leaves_held"], residual_l2=resid_norm,
        seconds_bits_gate=marks[1] - marks[0],
        seconds_main_path=marks[2] - marks[1])
    log(f"dp (A) main path: {json.dumps(numbers)}; bytes are what this "
        f"rank handed to each torch.distributed call in the last step "
        f"(payload; at world size 1 none crosses a link)")
    return numbers["launches_per_step"], numbers


def dp_virtual_mesh(dev):
    """(B): recurrentgemma-2b at full width cut to one super-block on a
    4-rank virtual mesh, global batch 4 x 1024, DP_STEPS steps with and
    without compression and one rank on the whole batch; a kernels-vs-
    plain DP step; the compressed step's synced gradients held to the
    scheme's own arithmetic on the ranks' quantized values (exactly), the
    ranks' targets to the uncompressed gradients, and the synced
    gradients to the uncompressed ones within the scheme's bound.
    Returns the record."""
    import dataclasses
    import gc
    import threading
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, RunConfig,
                                         ShardingConfig, TrainConfig)
    from repro_torch.core.params import param_count
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw, compression
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import dp_step, train_loop
    n = DP_B_RANKS
    arch = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=DP_B_LAYERS)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    per_rank = train_launch_plan(model.plan)
    tcfg = TrainConfig(warmup_steps=TRAIN_WARMUP)
    cfg = {c: RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                        sharding=ShardingConfig(gradient_compression=c),
                        train=tcfg) for c in (False, True)}
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, DP_B_BATCH, DP_B_S, step=s, seed=SEED).items()}
        for s in range(DP_STEPS)]
    mesh = VirtualMesh(n, dev)
    n_params = param_count(model.schema())
    tree_gib = n_params * 4 / 2**30
    log(f"dp (B): {TRAIN_ARCH} at full width, {DP_B_LAYERS} of 26 layers "
        f"({n_params} parameters), {n} virtual ranks, global batch "
        f"{DP_B_BATCH} x {DP_B_S}, {DP_STEPS} steps; reckoned: the shared "
        f"params, master and moments {4 * tree_gib:.3f} GiB, the ranks' "
        f"grads {n * tree_gib:.3f} and residuals {n * tree_gib:.3f}, "
        f"{(4 + 2 * n) * tree_gib:.3f} GiB before activations")
    captured = {}
    orig_update = adamw.update

    def capture_update(tag):
        def update(grads, st, params, lr, c):
            if tag not in captured:
                captured[tag] = [g.detach().clone() for g in
                                 leaves(grads)]
            return orig_update(grads, st, params, lr, c)
        return update

    peaks = {}

    def run(step_fn, tag, with_errors=False, launches=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(seed=SEED)
        state = adamw.init(params, tcfg)
        errors = (dp_step.init_error_feedback(params, mesh)
                  if with_errors else None)
        if tag in ("dp", "c"):      # step 0's synced gradients
            adamw.update = capture_update(tag)
        losses, metrics0 = [], None
        try:
            for s in range(DP_STEPS):
                before = dict(common.LAUNCHES)
                if tag == "one":
                    params, state, m = step_fn(params, state, batches[s], s)
                else:
                    params, state, errors, m = step_fn(params, state, errors,
                                                       batches[s], s)
                if launches is not None:
                    launches.append({k: common.LAUNCHES[k] - before[k]
                                     for k in per_rank})
                losses.append(float(m["loss"]))
                if s == 0:
                    metrics0 = {k: float(v) for k, v in m.items()}
        finally:
            adamw.update = orig_update
        del state, errors
        torch.cuda.synchronize()
        peaks[tag] = torch.cuda.max_memory_allocated() / 2**30
        return params, losses, metrics0

    t0 = time.perf_counter()
    dp_launches = []
    p_u, loss_u, m_u = run(dp_step.make_dp_train_step(
        model, cfg[False], mesh, total_steps=DP_STEPS), "dp", False,
        dp_launches)
    want = {k: n * c for k, c in per_rank.items()}
    if any(got != want for got in dp_launches):
        raise AssertionError(f"dp (B) steps launched {dp_launches}, want "
                             f"{want}")
    p_1, loss_1, _ = run(train_loop.make_train_step(
        model, cfg[False], total_steps=DP_STEPS), "one")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_u, loss_1))
    diff2 = sum(float((a.double() - b.double()).square().sum())
                for a, b in zip(leaves(p_u), leaves(p_1)))
    norm2 = sum(float(b.double().square().sum()) for b in leaves(p_1))
    param_rel = (diff2 / norm2) ** 0.5
    worst_abs = max(float((a - b).abs().max())
                    for a, b in zip(leaves(p_u), leaves(p_1)))
    del p_1
    log(f"dp (B) uncompressed DP on {n} ranks vs one rank on the whole "
        f"batch, {DP_STEPS} steps: losses {loss_u} / {loss_1} (largest "
        f"rel {loss_rel!r}), parameters' relative L2 distance "
        f"{param_rel!r}, largest |difference| {worst_abs!r}")
    if not (loss_rel <= DP_B_TOL and param_rel <= DP_B_TOL):
        raise AssertionError(f"dp (B): DP and one rank part: loss rel "
                             f"{loss_rel!r}, params rel {param_rel!r} "
                             f"(limit {DP_B_TOL})")
    del p_u
    gc.collect()
    torch.cuda.empty_cache()

    # kernels vs plain versions: one DP step at step 0 (lr 0) each
    _, _, m_plain = run(dp_step.make_dp_train_step(
        plain, cfg[False], mesh, total_steps=DP_STEPS), "plain")
    k_loss_rel = abs(m_u["loss"] - m_plain["loss"]) / abs(m_plain["loss"])
    k_norm_rel = abs(m_u["grad_norm"] - m_plain["grad_norm"]) / \
        abs(m_plain["grad_norm"])
    log(f"dp (B) step 0 with the kernels vs the plain versions: loss "
        f"{m_u['loss']!r} / {m_plain['loss']!r} (rel {k_loss_rel!r}), grad "
        f"norm {m_u['grad_norm']!r} / {m_plain['grad_norm']!r} (rel "
        f"{k_norm_rel!r})")
    if not (k_loss_rel <= TRAIN_LOSS_TOL and k_norm_rel <= TRAIN_NORM_TOL):
        raise AssertionError(f"dp (B): kernels and plain versions part: "
                             f"loss rel {k_loss_rel!r}, grad norm rel "
                             f"{k_norm_rel!r}")
    gc.collect()
    torch.cuda.empty_cache()

    # compressed: step 0's quantization as quantize_int8 returns it
    # inside compress_leaf, per (leaf index, chunk): the ranks' int8 values
    # summed as int32 (exact in any order), each rank's block scales, and
    # the ranks' targets summed; then the synced gradients against the
    # scheme's own arithmetic and against the uncompressed ones
    quant, calls, current = {}, [0] * n, {}
    orig_leaf, orig_quant = compression.compress_leaf, \
        compression.quantize_int8

    def leaf_probe(g, e, comm, *a, **kw):
        current[threading.get_ident()] = [calls[comm.rank], comm.rank, 0]
        calls[comm.rank] += 1
        return orig_leaf(g, e, comm, *a, **kw)

    def quant_probe(x, block=256):
        q, s = orig_quant(x, block)
        if "c" not in captured:           # step 0 (the update captures)
            cur = current[threading.get_ident()]
            k, r, j = cur
            cur[2] += 1
            rec = quant.get((k, j))
            if rec is None:
                rec = quant[(k, j)] = dict(
                    q=torch.zeros(q.shape, dtype=torch.int32, device=dev),
                    s=[None] * n, t=torch.zeros_like(x))
            rec["q"] += q
            rec["s"][r] = s
            rec["t"] += x
        return q, s

    compression.compress_leaf = leaf_probe
    compression.quantize_int8 = quant_probe
    try:
        p_c, loss_c, _ = run(dp_step.make_dp_train_step(
            model, cfg[True], mesh, total_steps=DP_STEPS), "c", True)
    finally:
        compression.compress_leaf = orig_leaf
        compression.quantize_int8 = orig_quant
    del p_c
    g_u, g_c = captured.pop("dp"), captured.pop("c")
    n_t = torch.full((), float(n), device=dev)
    worst, over_scale, n_vals, d2, u2 = 0.0, 0, 0, 0.0, 0.0
    not_exact, target_err = 0, 0.0
    for k, (gu, gc_) in enumerate(zip(g_u, g_c)):
        recs = []
        while (k, len(recs)) in quant:
            recs.append(quant.pop((k, len(recs))))
        # the scheme: dequant(sum q_i / n, sum scale_i / n), the scales
        # summed in rank order as the mesh's psum sums them
        deq = []
        for rec in recs:
            s_sum = rec["s"][0]
            for sr in rec["s"][1:]:
                s_sum = s_sum + sr
            deq.append(compression.dequantize_int8(
                rec["q"].float() / n_t, s_sum / n_t, (rec["t"].numel(),)))
        not_exact += int((torch.cat(deq) != gc_.reshape(-1)).sum())
        del deq
        # the ranks' targets (step 0: their own gradients) average to the
        # uncompressed synced gradient
        t_mean = torch.cat([rec["t"] for rec in recs]) * (1.0 / n)
        top = max(1e-30, float(gu.abs().max()))
        target_err = max(target_err, float(
            (t_mean - gu.reshape(-1)).abs().max()) / top)
        del t_mean
        s = torch.stack([torch.cat([rec["s"][r] for rec in recs])
                         for r in range(n)])          # (ranks, blocks)
        del recs
        s_mean = s.mean(0)
        bound = s_mean / 2 + 254 * (s - s_mean).abs().mean(0)
        nv = gu.numel()
        b = bound.repeat_interleave(256)[:nv]
        sm = s_mean.repeat_interleave(256)[:nv]
        d = (gc_.reshape(-1) - gu.reshape(-1)).abs()
        slop = 2.0 ** -20 * (gc_.reshape(-1).abs() + gu.reshape(-1).abs())
        worst = max(worst, float((d / (b + slop)).max()))
        over_scale += int((d > sm).sum())
        n_vals += nv
        d2 += float(d.double().square().sum())
        u2 += float(gu.double().square().sum())
    if quant:
        raise AssertionError(f"dp (B): {len(quant)} quantized chunks match "
                             "no synced gradient")
    del g_u, g_c
    rel_err = (d2 / u2) ** 0.5
    log(f"dp (B) compressed vs uncompressed, the synced gradients of step "
        f"0: {not_exact} of {n_vals} values differ from dequant(sum q_i / "
        f"n, sum scale_i / n) of the ranks' own int8 values; the ranks' "
        f"targets average to the uncompressed gradients within "
        f"{target_err!r} of each leaf's largest |grad| (limit {DP_B_TOL}); "
        f"relative L2 error {rel_err!r}; {over_scale} of {n_vals} values "
        f"off by more than their block's mean scale; the largest share of "
        f"the bound (mean scale / 2 + 254 x mean |scale_i - mean scale|) "
        f"{worst!r}; losses compressed {loss_c} / uncompressed {loss_u}")
    if not_exact:
        raise AssertionError(f"dp (B): {not_exact} synced values are not "
                             "the scheme's dequantized mean")
    if target_err > DP_B_TOL:
        raise AssertionError(f"dp (B): the ranks' targets average "
                             f"{target_err!r} away from the uncompressed "
                             "gradients")
    if worst > 1.0:
        raise AssertionError(f"dp (B): a compressed gradient passes the "
                             f"quantization bound ({worst!r} of it)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ranks=n, layers=DP_B_LAYERS, parameters=n_params,
                batch=[DP_B_BATCH, DP_B_S], losses_dp=loss_u,
                losses_one_rank=loss_1, losses_compressed=loss_c,
                loss_rel=loss_rel, param_rel_l2=param_rel,
                param_worst_abs=worst_abs, kernels_vs_plain_loss_rel=k_loss_rel,
                kernels_vs_plain_norm_rel=k_norm_rel,
                compressed_rel_l2=rel_err,
                compressed_values_not_exact=not_exact,
                compressed_target_mean_err=target_err,
                compressed_share_over_one_scale=over_scale / n_vals,
                compressed_worst_share_of_bound=worst,
                launches_per_step=dp_launches[-1], peak_gib_by_run=peaks,
                seconds=time.perf_counter() - t0)


def dp_moe_mesh(dev):
    """(C): phi3.5-moe at full width, DP_C_LAYERS layers, 1 x DP_C_S
    tokens, through ``LMModel(moe_mesh=VirtualMesh(MOE_EP_SHARDS))``
    against the same model without the mesh, at
    capacity factor MOE_EP_FACTOR (neither dispatch drops), logits and aux
    under the flip rule. Returns the record."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.models.lm import LMModel
    n = MOE_EP_SHARDS
    arch = with_capacity(dataclasses.replace(get_arch(MOE_ARCH),
                                             n_layers=DP_C_LAYERS),
                         MOE_EP_FACTOR)
    m = arch.moe
    sharded = LMModel(arch, moe_mesh=VirtualMesh(n, dev), device=dev)
    one = LMModel(arch, device=dev)
    params = one.init_params(seed=SEED)
    batch = {"tokens": torch.from_numpy(synth_batch(
        arch, 1, DP_C_S, step=0, seed=SEED)["tokens"]).to(dev)}
    t0 = time.perf_counter()
    rec_mesh, rec_one = [], []
    orig = sharded._moe_sharded
    el, sl = m.n_experts // n, DP_C_S // n
    cap = max(8, -(-int(sl * m.top_k / n * m.capacity_factor) // 8) * 8)

    def recording(p, h):
        ids = torch.cat([expert_ids(h[:, i * sl:(i + 1) * sl], p["router"],
                                    m.top_k) for i in range(n)], dim=1)
        dropped = 0
        for i in range(n):
            owner = ids[:, i * sl:(i + 1) * sl].reshape(-1) // el
            counts = torch.bincount(owner, minlength=n)
            dropped += int(torch.clamp(counts - cap, min=0).sum())
        rec_mesh.append(dict(ids=ids, capacity=cap, dropped=dropped))
        return orig(p, h)

    sharded._moe_sharded = recording
    with torch.no_grad():
        common.reset_launches()                 # just before the path
        got, _, aux = sharded.forward(params, batch)
        torch.cuda.synchronize()
        launched = {k: v for k, v in common.LAUNCHES.items() if v}
        with record_routing(rec_one):
            want, _, want_aux = one.forward(params, batch)
    if launched != {"flash_attention": DP_C_LAYERS} or \
            len(rec_mesh) != DP_C_LAYERS:
        raise AssertionError(f"dp (C): launched {launched}, "
                             f"{len(rec_mesh)} sharded MoE layers")
    flips = routing_flips(rec_one, rec_mesh)
    dropped = [max(a["dropped"], b["dropped"])
               for a, b in zip(rec_one, rec_mesh)]
    reach = flip_reach(flips, dropped, 1, DP_C_S)
    flip_gate(flips, held_shares(reach), "dp (C) moe_mesh")
    err, share = held_unreached(got[0], want[0], reach[0],
                                "dp (C) logits, moe_mesh vs one device")
    aux_rel = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
    if not flips and aux_rel > 1e-5:
        raise AssertionError(f"dp (C): aux {float(aux)!r} vs "
                             f"{float(want_aux)!r}")
    out = dict(shards=n, layers=DP_C_LAYERS, tokens=DP_C_S,
               capacity_factor=m.capacity_factor, dropped=dropped,
               flips=len(flips), flip_positions=flips[:20],
               logits_max_abs_err=err, logits_limit_share=share,
               aux_mesh=float(aux), aux_one=float(want_aux),
               aux_rel=aux_rel, launches=launched["flash_attention"],
               seconds=time.perf_counter() - t0)
    log(f"dp (C) {MOE_ARCH} through LMModel's moe_mesh on {n} virtual "
        f"shards vs one device: {json.dumps(out)}")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_phase(dev):
    """The data-parallel step on the card: (A) the main path, (B) 4
    virtual ranks, (C) the expert-parallel wiring. Returns ({kernel:
    launches per DP step of (A)}, the phase's numbers)."""
    import gc
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"dp phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "allocated before it")
    per_step, a = dp_main_path(dev)
    peak_line("dp (A)")
    marks = [time.perf_counter()]
    b = dp_virtual_mesh(dev)
    peak_line("dp (B)")
    marks.append(time.perf_counter())
    c = dp_moe_mesh(dev)
    peak_line("dp (C)")
    marks.append(time.perf_counter())
    log(f"dp phase: {marks[-1] - t0:.3f} s ((A) {marks[0] - t0:.3f}, (B) "
        f"{marks[1] - marks[0]:.3f}, (C) {marks[2] - marks[1]:.3f})")
    return per_step, dict(main_path=a, virtual_mesh=b, moe_mesh=c,
                          seconds=marks[-1] - t0)


# ---------------------------------------------------------------------------
# phase 11: phi3.5-moe served at full width, its expert-parallel dispatch
# ---------------------------------------------------------------------------
MOE_ARCH = "phi3.5-moe"
# 12 of 32 layers: 15.9B fp32 parameters, 59.1 GiB (32 layers are 167 GB
# in fp32 and 84 GB in bf16; neither fits one 80 GB card)
MOE_LAYERS = 12
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--requests", "32", "--wave-slots",
                  "8", "--max-new", "16", "--seed", str(SEED)]
MOE_PEAK_GIB = 76.0                       # the card's 80 GB, less headroom
# the expert-parallel check: one layer, 1 x 4096 tokens on 8 virtual
# shards (2 experts a shard) at capacity factor 8, where neither path
# drops (the sharded cap is T_loc * K); held within 1e-5 of the largest
# |output|
MOE_EP_SHARDS, MOE_EP_FACTOR, MOE_EP_TOL = 8, 8.0, 1e-5
MOE_TRAIN_LAYERS, MOE_TRAIN_S = 2, 512    # of 32; 1 x 512 tokens


def with_capacity(arch, factor):
    import dataclasses
    return dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, capacity_factor=factor))


def no_drop(arch):
    """The arch at capacity factor n_experts / top_k, where C >= T: the
    decode checks' capacity (at the published 1.25 a forward drops
    assignments that decode never drops)."""
    return with_capacity(arch, arch.moe.n_experts / arch.moe.top_k)


def moe_ep_check(dev, arch, x):
    """``moe_forward_sharded`` on 8 virtual shards (2 experts a shard)
    against ``moe_forward`` on the same full-width layer (seeded) and
    tokens x (1, S, d), at a capacity where neither drops, under the flip
    rule: a shard routes its 512 rows with the router's product over
    those rows, whose bits need not be the product's over all rows, so a
    token the two route to other experts is left out of the comparison."""
    import torch
    from repro_torch.core.params import init_params
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.models import moe as moe_mod
    n = MOE_EP_SHARDS
    arch = with_capacity(arch, MOE_EP_FACTOR)
    m = arch.moe
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p = init_params(moe_mod.moe_schema(arch), gen, torch.float32, dev)
    _, S, d = x.shape
    el, sl = m.n_experts // n, S // n
    inputs = [({"router": p["router"],
                **{k: p[k][i * el:(i + 1) * el]
                   for k in ("w_gate", "w_up", "w_down")}},
               x[:, i * sl:(i + 1) * sl]) for i in range(n)]
    mesh = VirtualMesh(n, dev)

    def sharded():
        return mesh.run(lambda comm, a: moe_mod.moe_forward_sharded(
            comm, a[0], a[1], arch), inputs)

    with torch.no_grad():
        want, want_aux = moe_mod.moe_forward(p, x, arch)
        outs = sharded()
        got = torch.cat([y for y, _ in outs], dim=1)
        ids_full = expert_ids(x[0], p["router"], m.top_k)
        ids_shard = torch.cat([expert_ids(x[0, i * sl:(i + 1) * sl],
                                          p["router"], m.top_k)
                               for i in range(n)])
        flipped = (ids_full != ids_shard).any(dim=-1)
        kept = ~flipped
        kept_share = float(kept.float().mean())
        flip_gate(torch.nonzero(flipped).flatten().tolist(), [kept_share],
                  f"moe_forward_sharded on {n} shards")
        top = float(want.abs().max())
        err = float((got[0][kept] - want[0][kept]).abs().max())
        if not bool(torch.isfinite(got).all()) or err > MOE_EP_TOL * top:
            raise AssertionError(f"moe_forward_sharded on {n} shards: off "
                                 f"by {err!r}, over {MOE_EP_TOL} of the "
                                 f"largest |output| {top!r}")
        full_ms = cuda_ms(lambda: moe_mod.moe_forward(p, x, arch), reps=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded()
        torch.cuda.synchronize()
        shard_ms = (time.perf_counter() - t0) * 1e3
        cap = max(8, -(-int(sl * m.top_k / n * m.capacity_factor) // 8) * 8)
        send = [torch.zeros((n, cap, d), device=dev) for _ in range(n)]
        mesh.run(lambda comm, s: comm.all_to_all(s), send)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.run(lambda comm, s: comm.all_to_all(s), send)
        torch.cuda.synchronize()
        a2a_ms = (time.perf_counter() - t0) * 1e3
    a2a_bytes = n * n * cap * d * 4
    rec = dict(shards=n, experts_per_shard=el, tokens=S, capacity=cap,
               capacity_factor=m.capacity_factor, max_abs_err=err,
               largest_abs_output=top, kept_share=kept_share,
               flips=int(flipped.sum()),
               flipped_positions=torch.nonzero(flipped).flatten().tolist(),
               aux_sharded=float(outs[0][1]),
               aux_full=float(want_aux), all_to_all_bytes=a2a_bytes,
               all_to_all_ms=a2a_ms, sharded_wall_ms=shard_ms,
               full_ms=full_ms)
    log(f"{MOE_ARCH} expert-parallel dispatch on {n} virtual shards vs "
        f"moe_forward (one layer, 1 x {S} tokens, factor "
        f"{m.capacity_factor}): {json.dumps(rec)}; all-to-all bytes are "
        f"one pass of the activations (x out; the results back are as "
        f"many), its ms the host clock around one exchange on the mesh")
    if len({float(a) for _, a in outs}) != 1:
        raise AssertionError(f"shards disagree on the aux loss: "
                             f"{[float(a) for _, a in outs]}")
    if abs(float(outs[0][1]) - float(want_aux)) > 1e-5 * abs(
            float(want_aux)):
        raise AssertionError(f"sharded aux {float(outs[0][1])!r} vs "
                             f"{float(want_aux)!r}")
    return rec


def moe_train_check(dev, arch):
    """phi3.5-moe at full width cut to MOE_TRAIN_LAYERS: one loss and
    backward with the flash kernel against the plain path, under the flip
    rule. Returns (the kernel's launches, the flips)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.lm import LMModel
    arch = dataclasses.replace(arch, n_layers=MOE_TRAIN_LAYERS)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    params = model.init_params(seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, 1, MOE_TRAIN_S, step=0, seed=SEED).items()}
    routed = [[], []]
    with torch.no_grad():
        for m_, rec in zip((model, plain), routed):
            with record_routing(rec):
                m_.forward(params, batch)
    flips = routing_flips(*routed)
    reach = flip_reach(flips, [max(a["dropped"], b["dropped"])
                               for a, b in zip(*routed)], 1, MOE_TRAIN_S)
    log(f"train: {MOE_ARCH} at full width, depth cut to {MOE_TRAIN_LAYERS} "
        f"of 32 layers, 1 x {MOE_TRAIN_S} tokens; dropped per layer "
        f"{[r['dropped'] for r in routed[0]]} at capacity "
        f"{routed[0][0]['capacity']}; kernels vs plain: {len(flips)} routing "
        f"flips {flips[:20]}")
    flip_gate(flips, held_shares(reach), f"{MOE_ARCH} loss and backward")
    launched = kernels_vs_plain_step(
        model, plain, params, batch,
        f"{MOE_ARCH} ({MOE_TRAIN_LAYERS} layers)",
        reach=reach if flips else None)
    if launched != {"flash_attention": 2 * MOE_TRAIN_LAYERS}:
        raise AssertionError(f"{MOE_ARCH} loss and backward launched "
                             f"{launched}")
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launched["flash_attention"], flips


def moe_phase(dev):
    """Serve phi3.5-moe at full width, depth cut to MOE_LAYERS: the prefill
    through ``LMModel.prefill`` (launch counts read around it, expert ids
    recorded), the flash kernel against its plain version at the
    prefill's own inputs, logits against the plain path and decode against
    forward under the flip rule, 32 requests through the launcher, the
    expert-parallel dispatch on 8 virtual shards, and one loss and
    backward at 2 layers. Returns (flash's shape record with its
    launches, the phase's numbers)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import LMModel

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    t_phase = time.perf_counter()
    arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    m = arch.moe
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = param_count(model.schema())
    log(f"MoE: {MOE_ARCH} at full width (d_model {arch.d_model}, "
        f"{arch.n_heads}/{arch.n_kv_heads} heads x "
        f"{arch.resolved_head_dim}, {m.n_experts} experts top-{m.top_k} of "
        f"d_expert {m.d_expert}, capacity factor {m.capacity_factor}, vocab "
        f"{arch.vocab_size}), depth cut to {MOE_LAYERS} of 32 layers: "
        f"{n_params} fp32 parameters ({n_params * 4 / 2**30:.3f} GiB) "
        f"drawn on the card in {time.perf_counter() - t0:.3f} s, seed {SEED}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(1, arch.vocab_size, (LM_B, LM_S), device=dev,
                           dtype=torch.int32, generator=gen)
    batch = {"tokens": tokens}

    routed = []
    with torch.no_grad(), record_routing(routed, keep_input=True):
        logits, launches, (fa_call,) = prefill_main_path(
            model, params, batch, "MoE", {"flash_attention": MOE_LAYERS},
            [(attn_mod, "flash_attention")])
    x0 = routed[0].pop("x")[:1]               # layer 0's MoE input, seq 0
    (q, k, v), fa_kw = fa_call
    with torch.no_grad():
        fa_rec = attention_record(q, k, v, f"{MOE_ARCH} prefill (layer 0)",
                                  fa_kw["scale"])
        del q, k, v, fa_call
        numbers = lm_prefill_checks(model, plain, params, batch, logits,
                                    "MoE", routed=routed)
        if numbers["prefill_peak_gib"] >= MOE_PEAK_GIB:
            raise AssertionError(f"MoE prefill peak "
                                 f"{numbers['prefill_peak_gib']:.3f} GiB "
                                 f"reaches {MOE_PEAK_GIB}")
        dec_flips = decode_vs_forward(no_drop(arch), params, tokens,
                                      "tokens", dev, "MoE", routed=True)
    del params, plain, model, logits, routed
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("MoE prefill, kernel, decode vs forward")
    t_serve = time.perf_counter()
    wave_ms, wave_device, serve_peak = lm_serving(MOE_SERVE_ARGV, "MoE",
                                                  arch=arch)
    if serve_peak >= MOE_PEAK_GIB:
        raise AssertionError(f"MoE serving peak {serve_peak:.3f} GiB "
                             f"reaches {MOE_PEAK_GIB}")
    t_ep = time.perf_counter()
    ep = moe_ep_check(dev, arch, x0)
    del x0
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("MoE expert-parallel dispatch")
    t_train = time.perf_counter()
    train_launches, train_flips = moe_train_check(dev, arch)
    peak_line(f"MoE loss and backward, {MOE_TRAIN_LAYERS} layers")
    t_end = time.perf_counter()
    numbers.update(
        layers=MOE_LAYERS, params=n_params, decode_flips=dec_flips,
        wave_ms=wave_ms, wave_device=wave_device, serve_peak_gib=serve_peak,
        expert_parallel=ep,
        train_launches=train_launches, train_flips=train_flips,
        seconds=dict(prefill_checks=t_serve - t_phase,
                     serving=t_ep - t_serve, expert_parallel=t_train - t_ep,
                     train=t_end - t_train, total=t_end - t_phase))
    log(f"MoE phase: {t_end - t_phase:.3f} s")
    fa_rec.update(launches=launches, launches_train=train_launches)
    return fa_rec, numbers


# ---------------------------------------------------------------------------
# phase 12: qwen2-vl-2b and musicgen-large at full width and depth
# ---------------------------------------------------------------------------
VLM_ARCH, AUDIO_ARCH = "qwen2-vl-2b", "musicgen-large"
AUDIO_SERVE_ARGV = ["--arch", AUDIO_ARCH, "--requests", "8", "--wave-slots",
                    "8", "--max-new", "16", "--seed", str(SEED)]


def family_run(dev, name):
    """One family at full width and depth: a 2 x 4096 prefill from the
    data pipeline's batch (qwen2-vl: 1,024 patch embeddings with their 3-D
    positions, then 3,072 text tokens; musicgen: frame embeddings, 4
    codebook heads), flash against its plain version at that prefill's
    inputs, logits against the plain path, decode against forward
    (musicgen's steps take the frame embeddings one at a time). Returns
    flash's shape record with its launches."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import LMModel
    arch = get_arch(name)
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(seed=SEED)
    n_params = param_count(model.schema())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, LM_B, LM_S, step=0, seed=SEED).items() if k != "labels"}
    log(f"{name} at full width and depth ({arch.n_layers} layers, d_model "
        f"{arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads x "
        f"{arch.resolved_head_dim}, vocab {arch.vocab_size}): {n_params} fp32 "
        f"parameters ({n_params * 4 / 2**30:.3f} GiB), seed {SEED}; batch "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
    with torch.no_grad():
        logits, launches, (fa_call,) = prefill_main_path(
            model, params, batch, name, {"flash_attention": arch.n_layers},
            [(attn_mod, "flash_attention")])
        (q, k, v), fa_kw = fa_call
        fa_rec = attention_record(q, k, v, f"{name} prefill (layer 0)",
                                  fa_kw["scale"])
        del q, k, v, fa_call
        lm_prefill_checks(model, plain, params, batch, logits, name)
        key = "embeds" if arch.n_codebooks else "tokens"
        decode_vs_forward(arch, params, batch[key], key, dev, name)
    del params, plain, model, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    peak_line(f"{name} prefill, kernel, decode vs forward")
    fa_rec.update(launches=launches)
    return fa_rec


def families_phase(dev):
    """qwen2-vl-2b and musicgen-large at full width and depth, then a short
    served run of musicgen (its waves feed codes). Returns flash's two
    shape records."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    t0 = time.perf_counter()
    recs = [family_run(dev, VLM_ARCH), family_run(dev, AUDIO_ARCH)]
    lm_serving(AUDIO_SERVE_ARGV, "audio")
    log(f"families phase: {time.perf_counter() - t0:.3f} s")
    return recs


# ---------------------------------------------------------------------------
# phase 13: deepseek-v3 (MLA, 256 experts top-8, the MTP head) at full width
# ---------------------------------------------------------------------------
MLA_ARCH = "deepseek-v3"
# 4 of 61 layers: the 3 leading dense layers and the first MoE layer, and
# the MTP head: 15.80B fp32 parameters, 58.85 GiB (one more MoE layer adds
# 46 GB: no cut with it fits one 80 GB card)
MLA_LAYERS = 4
MLA_SERVE_ARGV = ["--arch", MLA_ARCH, "--requests", "8", "--wave-slots",
                  "8", "--max-new", "16", "--seed", str(SEED)]
MLA_PEAK_GIB = 76.0                       # the card's 80 GB, less headroom
# one loss_fn, forward only, at 1 x 1024 tokens (a backward at full width
# does not fit: the MoE layer's grads alone are another 42 GiB); the
# losses of the kernels' pass and the plain one within 1e-5 relative
MLA_LOSS_S, MLA_LOSS_TOL = 1024, 1e-5


def mla_attention_record(q, k, v, label, scale, v_dim):
    """``attention_record`` at MLA's call (v zero-padded to q's head dim),
    and SDPA (fp32, ``is_causal``) on v at its own ``v_dim`` columns,
    which SDPA takes where the kernel does not. SDPA is held to its
    memory-efficient backend: its math fallback would build the (2, 128,
    4096, 4096) fp32 scores, 17 GB, beside the 59 GiB of weights."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_chunked
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        rec = attention_record(q, k, v, label, scale)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v[..., :v_dim]))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                              is_causal=True)
        want = attention_chunked(q, k, v, scale=scale)[..., :v_dim]
        rec["library_unpadded_max_abs_err"] = float(
            (sdpa.transpose(1, 2) - want).abs().max())
        del sdpa, want
        rec["library_unpadded_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                                   is_causal=True), reps=3)
    rec["library"] = "SDPA, memory-efficient backend"
    log(f"flash_attention {label}: SDPA on v at its {v_dim} columns "
        f"{rec['library_unpadded_ms']!r} ms, max_abs_err "
        f"{rec['library_unpadded_max_abs_err']!r}")
    return rec


def mla_loss_check(model, plain, params, batch, label):
    """One ``loss_fn`` (forward only) with the kernels and with the plain
    versions, the kernels' launches counted around the first; under the
    flip rule: without a routing flip ce, aux, mtp and the total are held
    within MLA_LOSS_TOL relative, else the last layer's output where no
    flip reaches within PREFILL_TOL. Returns (launches, flips, losses)."""
    import torch
    from repro_torch.kernels import common
    routed, hidden, losses = [[], []], [], []
    with torch.no_grad():
        for i, (m_, rec) in enumerate(zip((model, plain), routed)):
            seen = []
            torch.cuda.synchronize()
            if i == 0:
                common.reset_launches()         # just before the path
            with record_routing(rec), capture(m_, "_head", seen, keep=1):
                total, metrics = m_.loss_fn(params, batch)
            torch.cuda.synchronize()
            if i == 0:
                launches = {n: c for n, c in common.LAUNCHES.items() if c}
            hidden.append(seen[0][0][1])
            losses.append(dict({k: float(v) for k, v in metrics.items()},
                               total=float(total)))
    S = batch["tokens"].shape[1]
    flips = routing_flips(*routed)
    reach = flip_reach(flips, [max(a["dropped"], b["dropped"])
                               for a, b in zip(*routed)], 1, S)
    log(f"{label} loss_fn (forward) at 1 x {S}: kernels {losses[0]}, plain "
        f"{losses[1]}; dropped per MoE layer "
        f"{[r['dropped'] for r in routed[0]]} at capacity "
        f"{routed[0][0]['capacity']}; {len(flips)} routing flips "
        f"{flips[:20]}; launches {launches}")
    flip_gate(flips, held_shares(reach), f"{label} loss_fn")
    if flips:
        err, rel = held_unreached(hidden[0][0], hidden[1][0], reach[0],
                                  f"{label} loss_fn last layer's output "
                                  f"where no routing flip reaches")
        log(f"{label} loss_fn: routing flips {flips}: the last layer's "
            f"output held at the {int((~reach).sum())} of {S} positions "
            f"none reaches, max_abs_err {err!r}, limit share {rel!r}; the "
            f"losses not held")
    else:
        for key in ("ce", "aux", "mtp", "total"):
            got, want = losses[0][key], losses[1][key]
            if abs(got - want) > MLA_LOSS_TOL * abs(want):
                raise AssertionError(f"{label} loss_fn {key}: kernels "
                                     f"{got!r}, plain {want!r}, over "
                                     f"{MLA_LOSS_TOL} relative")
    return launches, flips, losses


def mla_phase(dev):
    """Serve deepseek-v3 at full width, depth cut to MLA_LAYERS (+ the MTP
    head): the 2 x 4096 prefill through ``LMModel.prefill`` at the
    published capacity factor (launch counts read around it, expert ids
    recorded), flash at D 192 against its plain version at the prefill's
    own inputs with its times, logits against the plain path and decode
    (the absorbed latent form) against forward at the no-drop factor,
    under the flip rule; 8 requests through the launcher; one forward
    ``loss_fn`` with the MTP head, kernels against plain. Returns (flash's
    shape record with its launches, the phase's numbers)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.params import param_count
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import LMModel

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as the
    torch.backends.cudnn.allow_tf32 = False         # reference's
    t_phase = time.perf_counter()
    arch = dataclasses.replace(get_arch(MLA_ARCH), n_layers=MLA_LAYERS)
    m, mla = arch.moe, arch.mla
    model = LMModel(arch, device=dev)
    plain = LMModel(arch, device=dev, kernel_mode="ref")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = param_count(model.schema())
    log(f"MLA: {MLA_ARCH} at full width (d_model {arch.d_model}, "
        f"{arch.n_heads} heads, MLA q_lora {mla.q_lora_rank} kv_lora "
        f"{mla.kv_lora_rank} qk {mla.qk_nope_head_dim}+"
        f"{mla.qk_rope_head_dim} v {mla.v_head_dim}, {m.n_experts} experts "
        f"top-{m.top_k} of d_expert {m.d_expert} + {m.n_shared_experts} "
        f"shared, {m.n_dense_layers} dense layers of d_ff {m.dense_d_ff}, "
        f"capacity factor {m.capacity_factor}, vocab {arch.vocab_size}, the "
        f"MTP head), depth cut to {MLA_LAYERS} of 61 layers: {n_params} "
        f"fp32 parameters ({n_params * 4 / 2**30:.3f} GiB) drawn on the card "
        f"in {time.perf_counter() - t0:.3f} s, seed {SEED}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(1, arch.vocab_size, (LM_B, LM_S), device=dev,
                           dtype=torch.int32, generator=gen)
    batch = {"tokens": tokens}

    routed = []
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), record_routing(routed):
        logits, launches, (fa_call,) = prefill_main_path(
            model, params, batch, "MLA", {"flash_attention": MLA_LAYERS},
            [(attn_mod, "flash_attention")])
    first_peak = peak_line("MLA first prefill (the captured q/k/v held)")
    (q, k, v), fa_kw = fa_call
    del fa_call
    with torch.no_grad():
        fa_rec = mla_attention_record(
            q, k, v, f"{MLA_ARCH} prefill (layer 0, D 192, v padded from "
            f"{mla.v_head_dim})", fa_kw["scale"], mla.v_head_dim)
        del q, k, v
        numbers = lm_prefill_checks(model, plain, params, batch, logits,
                                    "MLA", routed=routed)
        if max(first_peak, numbers["prefill_peak_gib"]) >= MLA_PEAK_GIB:
            raise AssertionError(f"MLA prefill peak {first_peak:.3f} / "
                                 f"{numbers['prefill_peak_gib']:.3f} GiB "
                                 f"reaches {MLA_PEAK_GIB}")
        t_dec = time.perf_counter()
        dec_flips = decode_vs_forward(no_drop(arch), params, tokens,
                                      "tokens", dev, "MLA", routed=True)
        t_loss = time.perf_counter()
        loss_batch = {k_: torch.from_numpy(v_).to(dev)
                      for k_, v_ in synth_batch(arch, 1, MLA_LOSS_S, step=0,
                                                seed=SEED).items()}
        loss_launches, loss_flips, losses = mla_loss_check(
            model, plain, params, loss_batch, "MLA")
    if loss_launches != {"flash_attention": MLA_LAYERS + 1}:
        raise AssertionError(f"MLA loss_fn launched {loss_launches}, want "
                             f"{MLA_LAYERS + 1} flash_attention (the "
                             f"layers and the MTP head's)")
    del params, plain, model, logits, routed, loss_batch
    gc.collect()
    torch.cuda.empty_cache()
    peak_line("MLA loss_fn")
    t_serve = time.perf_counter()
    wave_ms, wave_device, serve_peak = lm_serving(MLA_SERVE_ARGV, "MLA",
                                                  arch=arch)
    if serve_peak >= MLA_PEAK_GIB:
        raise AssertionError(f"MLA serving peak {serve_peak:.3f} GiB "
                             f"reaches {MLA_PEAK_GIB}")
    t_end = time.perf_counter()
    kinds = numbers["prefill_device"]["device_ms_by_kind"]
    busy = sum(kinds.values())
    numbers.update(
        layers=MLA_LAYERS, params=n_params, first_prefill_peak_gib=first_peak,
        prefill_products_share=kinds.get("matmul", 0.0) / busy if busy
        else "not measured", decode_flips=dec_flips, loss=losses[0],
        loss_plain=losses[1], loss_flips=loss_flips, wave_ms=wave_ms,
        wave_device=wave_device, serve_peak_gib=serve_peak,
        seconds=dict(prefill_checks=t_dec - t_phase,
                     decode_vs_forward=t_loss - t_dec,
                     loss=t_serve - t_loss, serving=t_end - t_serve,
                     total=t_end - t_phase))
    log(f"MLA phase: {t_end - t_phase:.3f} s")
    fa_rec.update(launches=launches["flash_attention"],
                  launches_loss=loss_launches["flash_attention"])
    return fa_rec, numbers


# ---------------------------------------------------------------------------
# phase 14: the dry run's one-card predictions held against the card
# ---------------------------------------------------------------------------
# The dry run (``launch/dryrun.py``) builds a cell's step and arguments on
# fake tensors (``build_cell``) and traces it (``trace``); the same step is
# then run on real arguments drawn to the same specs. Its peak above the
# arguments is held within 10% of the measured rise of
# ``max_memory_allocated`` over the step, its FLOPs to a FlopCounterMode
# around the real step exactly, and the sharding plan's argument bytes
# (``argument_bytes_per_device``) to the real arguments' bytes exactly and
# to their allocation within the caching allocator's slack: each block
# rounded up to 512 bytes, and a block of more than 1 MiB handed out
# whole when what it would leave over is no more than 1 MiB (c10's
# kMinBlockSize and kSmallSize)
DRYRUN_PEAK_TOL = 0.10
DRYRUN_DECODE_B = 8                       # the serving waves' 8 lanes
ALLOC_SMALL = 1 << 20


def alloc_slack(tensors) -> int:
    """The most the caching allocator can hand out beyond ``tensors``'
    bytes (each storage once): 512-byte rounding, and up to 1 MiB more
    for a storage of more than 1 MiB."""
    seen, slack = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        n = st.nbytes()
        slack += -n % 512 + (ALLOC_SMALL if n > ALLOC_SMALL else 0)
    return slack


def dryrun_no_device_work(label, fn):
    """``fn()`` with the gates of a trace: the card's allocated and peak
    bytes unchanged and no kernel launched. Returns (fn's result, its wall
    seconds)."""
    import torch
    from repro_torch.kernels import common
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    common.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    alloc1 = torch.cuda.memory_allocated()
    peak1 = torch.cuda.max_memory_allocated()
    launched = {n: c for n, c in common.LAUNCHES.items() if c}
    if alloc1 != alloc0 or peak1 != alloc0 or launched:
        raise AssertionError(f"dryrun {label}: allocated {alloc0} -> "
                             f"{alloc1} bytes, peak {peak1}, launches "
                             f"{launched}")
    return out, seconds


def dryrun_real_args(model, shape, mesh, cfg):
    """The step's arguments on the card, to the specs ``build_cell``
    traced, seeded: ``init_params`` at ``cfg.param_dtype``, AdamW's state
    for a train step, a batch of random token ids (random floats for a
    float leaf) to ``batch_specs``, a decode step's cache filled to one
    short of its capacity."""
    import torch
    from repro_torch.core.config import StepKind
    from repro_torch.launch.sharding_plan import batch_specs
    from repro_torch.optim import adamw
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init_params(seed=SEED,
                               dtype=getattr(torch, cfg.param_dtype))
    batch = {}
    for name, m in batch_specs(model.arch, shape, mesh,
                               cfg.sharding.strategy)["specs"].items():
        batch[name] = (torch.randn(m.shape, device=dev, generator=gen).to(
            m.dtype) if m.dtype.is_floating_point else torch.randint(
            1, model.arch.vocab_size, m.shape, device=dev, dtype=m.dtype,
            generator=gen))
    if shape.kind == StepKind.TRAIN:
        return params, adamw.init(params, cfg.train), batch, 0
    if shape.kind == StepKind.PREFILL:
        return params, batch
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             fill_len=shape.seq_len - 1)
    return params, cache, batch


def dryrun_hold(label, cfg):
    """The cell of ``cfg`` on the one-card mesh: ``build_cell`` and
    ``trace`` on fake tensors under the gates of a trace, then the same
    model's step on real arguments drawn to the same specs (after
    ``reset_peak_memory_stats``) under the same counters. Gates: the
    arguments' shapes and dtypes equal the traced ones, their bytes the
    plan's ``argument_bytes_per_device`` and their allocation within the
    allocator's slack (``alloc_slack``); FLOPs equal; outputs' shapes and dtypes equal;
    the predicted step peak within DRYRUN_PEAK_TOL of the measured rise.
    Then the step's warm ms by CUDA events, beside the roofline's memory
    and compute ms (data-sheet bytes/s, float32 FLOP/s: the products run
    in fp32). Returns the cell's record."""
    import gc
    import torch
    from repro_torch.launch import dryrun
    mesh = dryrun.one_card_mesh()

    def traced():
        with dryrun.fake_card() as fdev:
            model, fn, fargs = dryrun.build_cell(cfg.arch, cfg.shape, mesh,
                                                 cfg)
            return model, fn, dryrun.describe(fargs), dryrun.trace(
                fn, fargs, fdev)
    (model, step, spec, pred), seconds = dryrun_no_device_work(label, traced)
    plan = dryrun.argument_bytes_per_device(model, cfg, mesh)
    torch.cuda.synchronize()
    before_args = torch.cuda.memory_allocated()
    args = dryrun_real_args(model, cfg.shape, mesh, cfg)
    torch.cuda.synchronize()
    args_alloc = torch.cuda.memory_allocated() - before_args
    tensors = dryrun._tensors(args)
    args_bytes = sum(t.untyped_storage().nbytes() for t in tensors)
    slack = alloc_slack(tensors)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    real = dryrun.trace(step, args, model.device)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    ms = cuda_ms(lambda: step(*args), reps=1, warmup=0)
    real_spec = dryrun.describe(args)
    outputs = real.pop("outputs")
    del args, step, model
    gc.collect()
    torch.cuda.empty_cache()
    off = (pred["step_peak_bytes"] - rise) / rise
    rec = dict(
        cell=label, trace_s=seconds, trace_device=str(dryrun.card_stand_in()),
        param_dtype=cfg.param_dtype, flops=pred["flops"],
        real_flops=real["flops"], bytes=pred["bytes"],
        plan_argument_bytes=plan["total"], real_argument_bytes=args_bytes,
        real_argument_allocated=args_alloc, allocator_slack_bound=slack,
        argument_tensors=len(tensors),
        predicted_step_peak_bytes=pred["step_peak_bytes"],
        measured_step_peak_bytes=rise,
        tracked_real_step_peak_bytes=real["step_peak_bytes"],
        real_bytes=real["bytes"], peak_rel_err=off,
        predicted_total_gib=(plan["total"] + pred["step_peak_bytes"])
        / 2**30,
        measured_total_gib=(args_alloc + rise) / 2**30,
        roofline_memory_ms=pred["bytes"] / HBM_BYTES_PER_S * 1e3,
        roofline_compute_ms=pred["flops"] / F32_OPS_PER_S * 1e3,
        measured_ms=ms)
    log(f"dryrun {label}: {json.dumps(rec)}")
    if real_spec != spec:
        raise AssertionError(f"dryrun {label}: real arguments {real_spec}, "
                             f"traced {spec}")
    # the train step's counter is a Python int, an int32 in the plan
    if args_bytes + plan.get("step", 0) != plan["total"] or not (
            0 <= args_alloc - args_bytes <= slack):
        raise AssertionError(f"dryrun {label}: the plan's argument bytes "
                             f"{plan['total']}, the arguments' {args_bytes}"
                             f", allocated {args_alloc} (slack at most "
                             f"{slack})")
    if real["flops"] != pred["flops"]:
        raise AssertionError(f"dryrun {label}: traced FLOPs {pred['flops']}"
                             f", the real step's {real['flops']}")
    if outputs != pred["outputs"]:
        raise AssertionError(f"dryrun {label}: outputs {outputs} traced as "
                             f"{pred['outputs']}")
    if abs(off) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dryrun {label}: predicted step peak "
                             f"{pred['step_peak_bytes']} bytes, measured "
                             f"{rise}: {off:+.4f}, beyond {DRYRUN_PEAK_TOL}")
    return rec


def dryrun_cut(label, arch, shape, want_fit, **kw):
    """A depth cut of the script's against the dry run's one-card verdict:
    ``run_cell(..., one_card=True)["fits"]`` (the plan's argument bytes
    plus the traced step peak, under the card's memory) must be
    ``want_fit``."""
    import torch
    from repro_torch.launch import dryrun
    rates = dict(dryrun.H100_SXM, device_memory=float(
        torch.cuda.get_device_properties(0).total_memory))
    rep, seconds = dryrun_no_device_work(label, lambda: dryrun.run_cell(
        arch, shape, multi_pod=False, one_card=True, param_dtype="float32",
        rates_source=dryrun.H100_SXM_SOURCE + "; device memory: the "
        "card's total_memory", verbose=False, **rates, **kw))
    rec = dict(cut=label, trace_s=seconds, fits=rep["fits"],
               argument_gib=rep["argument_bytes_per_device"]["total"] / 2**30,
               step_peak_gib=rep["temp_bytes_per_device"] / 2**30,
               total_gib=rep["bytes_per_device"] / 2**30,
               limit_gib=rep["device_memory"] / 2**30)
    log(f"dryrun cut {label}: {json.dumps(rec)}")
    if rep["fits"] is not want_fit:
        raise AssertionError(f"dryrun cut {label}: fits {rep['fits']}, the "
                             f"script's cut says {want_fit}")
    return rec


def dryrun_phase(dev):
    """The dry run's predictions against the card, at float32 parameters
    as the script runs them: (a) recurrentgemma-2b's train step at full
    depth, 1 x 4096; (b) recurrentgemma-2b's and rwkv6-7b's 2 x 4096
    prefills; (c) phi3.5-moe's prefill at the MoE phase's 12 of 32 layers;
    (d) one recurrentgemma-2b decode step; then the script's depth cuts
    by ``run_cell``'s verdict: phi3.5-moe's 2 x 4096 prefill fits at 12
    layers and not at 32; deepseek-v3 at 4 layers and 1 x 1024, its
    forward (a prefill) fits and its train step does not. Returns the
    phase's numbers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (RunConfig, ShapeConfig, StepKind,
                                         TrainConfig)
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # FakeTensorMode's one-time set-up on the card (a 1-element tensor,
    # freed), made by the first fake_card of the process: before the gates
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    with dryrun.fake_card():
        pass
    warm = torch.cuda.max_memory_allocated() - alloc0
    log(f"dryrun: the first fake_card's set-up: {warm} bytes at peak, "
        f"{torch.cuda.memory_allocated() - alloc0} kept")

    def cfg(arch, kind, B, S, **train):
        shape = ShapeConfig(f"{kind}_{B}x{S}", StepKind(kind), S, B)
        return RunConfig(arch=arch, shape=shape, param_dtype="float32",
                         train=TrainConfig(**train))
    rg, phi = get_arch(LM_ARCH), get_arch(MOE_ARCH)
    phi_cut = dataclasses.replace(phi, n_layers=MOE_LAYERS)
    cells = [
        dryrun_hold("(a) recurrentgemma-2b train step, 1 x 4096",
                    cfg(rg, "train", TRAIN_B, TRAIN_S,
                        warmup_steps=TRAIN_WARMUP)),
        dryrun_hold("(b) recurrentgemma-2b prefill, 2 x 4096",
                    cfg(rg, "prefill", LM_B, LM_S)),
        dryrun_hold("(b) rwkv6-7b prefill, 2 x 4096",
                    cfg(get_arch(RWKV_ARCH), "prefill", LM_B, LM_S)),
        dryrun_hold(f"(c) phi3.5-moe prefill, {MOE_LAYERS} of 32 layers, "
                    f"2 x 4096", cfg(phi_cut, "prefill", LM_B, LM_S)),
        dryrun_hold(f"(d) recurrentgemma-2b decode step, B "
                    f"{DRYRUN_DECODE_B}, cache {LM_S}",
                    cfg(rg, "decode", DRYRUN_DECODE_B, LM_S)),
    ]
    ds = dataclasses.replace(get_arch(MLA_ARCH), n_layers=MLA_LAYERS)
    prefill = ShapeConfig(f"prefill_{LM_B}x{LM_S}", StepKind.PREFILL, LM_S,
                          LM_B)
    cuts = [
        dryrun_cut(f"phi3.5-moe prefill at {MOE_LAYERS} layers", phi_cut,
                   prefill, True),
        dryrun_cut("phi3.5-moe prefill at 32 layers", phi, prefill, False),
        dryrun_cut(f"deepseek-v3 forward (prefill) at {MLA_LAYERS} layers, "
                   f"1 x {MLA_LOSS_S}", ds, ShapeConfig(
                       "prefill_1x1024", StepKind.PREFILL, MLA_LOSS_S, 1),
                   True),
        dryrun_cut(f"deepseek-v3 train step at {MLA_LAYERS} layers, 1 x "
                   f"{MLA_LOSS_S}", ds, ShapeConfig(
                       "train_1x1024", StepKind.TRAIN, MLA_LOSS_S, 1),
                   False, accum=1),
    ]
    seconds = time.perf_counter() - t0
    log(f"dryrun phase: {seconds:.3f} s")
    return dict(cells=cells, cuts=cuts, first_fake_card_bytes=warm,
                seconds=seconds)


# ---------------------------------------------------------------------------
# the sharded step: the sharding plan through DTensor over a one-rank NCCL
# mesh, and the dry run's pod-mesh reports
# ---------------------------------------------------------------------------
SHARDED_POLICY = "interleave"
SHARDED_MESH = (("data", "model"), (1, 1))   # NCCL: one rank a card
# (d): two ranks on the one card, threads of this process
# (``threaded_ranks``), each mesh splitting one axis in two; full width,
# the depths cut (recurrentgemma-2b: one super-block, its two recurrent
# layers and its attention layer), 2 x 256 tokens, a loss with its
# gradients, then a train step at step 1 (step 0's learning rate is 0)
SPLIT_RANKS = 2
SPLIT_MESHES = ((1, 2), (2, 1))               # (data, model)
# (model, layers, its kernels)
SPLIT_ARCHS = (("recurrentgemma-2b", 3, ("flash_attention", "rglru_scan")),
               ("rwkv6-7b", 2, ("wkv6",)))
SPLIT_B, SPLIT_S, SPLIT_STEPS = 2, 256, 1
SPLIT_TIMEOUT_S = 300.0
# against the unsharded kernel route on the same card, distances relative
# by L2 norm: the losses 1e-5; each gradient leaf 1e-3, the level at which
# the training phase holds the kernels' grad norm to the plain route's
# (the backward sums a split product's halves where the unsharded route
# sums it whole: rwkv6-7b's w_r gradient parts by 1.6e-4 where only the
# two batch halves' sum differs); the parameters after the steps 1e-5, as
# DP phase (B) holds its ranks (AdamW scales each element's step by its
# own gradient's size, so the largest single difference is a share of the
# learning rate)
SPLIT_LOSS_RTOL, SPLIT_GRAD_REL, SPLIT_PARAM_REL = 1e-5, 1e-3, 1e-5
# the pod-mesh reports (arch, shape, 2 x 16 x 16?), run after every timed
# phase: rank 0 of the sharded step traced under a fake group beside the
# whole step's trace (yi-34b's and rwkv6-7b's train cells take minutes
# each: PERF.md has their reports from the dry run's CLI)
SHARDED_POD_CELLS = (("recurrentgemma-2b", "train_4k", False),
                     ("qwen3-1.7b", "decode_32k", False),
                     ("qwen3-1.7b", "decode_32k", True))
# (e): phi3.5-moe over the one-rank NCCL mesh at full width (16 experts,
# top-2, d_expert 6400), 2 of 32 layers, 1 x 4096, 3 sharded train steps
# through the expert-parallel dispatch (``moe_mesh`` the device mesh),
# against the same steps through ``moe_mesh=VirtualMesh(1)``, the same
# dispatch's arithmetic on one virtual shard: bit-equal
MOE_SHARDED_LAYERS, MOE_SHARDED_S = 2, 4096
# (f): two ranks sharing the card (``threaded_ranks``) on a (data 1,
# model 2) mesh, a real all-to-all between them: phi3.5-moe at 2 layers (8
# experts a rank), a forward, a loss with its gradients and a train step
# at step 1; deepseek-v3 at MLA_LAYERS (3 dense, 1 MoE with its shared
# expert, the MTP head; its experts over ("data", "model")), a forward and
# a forward ``loss_fn``; 1 x SPLIT_MOE_S tokens; against the unsharded
# route through ``moe_mesh=VirtualMesh(2)``, run first, its results kept
# on the host. Gates: (d)'s, and the logits within SPLIT_MOE_LOGITS_TOL
# where no routing flip reaches (the flip rule); with a flip the loss,
# grads and parameters are reported, not held
SPLIT_MOE_S = 1024
SPLIT_MOE_LOGITS_TOL = 1e-4
SPLIT_MOE_CASES = (("phi3.5-moe", MOE_SHARDED_LAYERS, True),
                   ("deepseek-v3", MLA_LAYERS, False))  # (model, layers,
                                                        # train?)


def sharded_mesh():
    import numpy as np
    from repro_torch.core.partitioning import MeshSpec
    names, sizes = SHARDED_MESH
    return MeshSpec(names, sizes, np.zeros(sizes, np.int64))


def sharded_train(dev, group):
    """(a): recurrentgemma-2b at full width and depth on the training
    phase's cell (TRAIN_B x TRAIN_S, fp32 parameters from SEED), sequence
    parallel, policy SHARDED_POLICY: first TRAIN_STEPS unsharded
    ``train_loop`` steps (the bits to hold), then (c)'s trace of rank 0
    of the sharded cell on the one-rank mesh (no device work), then, in
    ``group`` (the one-rank NCCL group, opened by the callback), the same
    steps through the sharded step: parameters and opt state placed by
    the plan as DTensors, the launch counts zeroed just before and read
    just after each step. Gates: losses and parameters bit-equal to the
    unsharded steps; every step's launches those of the training phase's
    step; each kernel reached through its sharding rule; the peak under
    TRAIN_PEAK_GIB; the traced step peak
    within DRYRUN_PEAK_TOL of step 0's measured rise. Returns the record."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, PlacementPolicy,
                                         RunConfig, ShapeConfig,
                                         ShardingConfig, StepKind,
                                         TrainConfig)
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import train_loop
    arch = get_arch(TRAIN_ARCH)
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(warmup_steps=TRAIN_WARMUP),
                    sharding=ShardingConfig(
                        policy=PlacementPolicy(SHARDED_POLICY),
                        sequence_parallel=True))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, TRAIN_B, TRAIN_S, step=s, seed=SEED).items()}
        for s in range(TRAIN_STEPS)]
    marks = [time.perf_counter()]

    # the unsharded steps
    model = LMModel(arch, device=dev)
    want = train_launch_plan(model.plan)
    params = model.init_params(seed=SEED)
    state = adamw.init(params, cfg.train)
    step_fn = train_loop.make_train_step(model, cfg, total_steps=TRAIN_STEPS)
    plain_losses = []
    for s in range(TRAIN_STEPS):
        params, state, m = step_fn(params, state, batches[s], s)
        plain_losses.append(m["loss"].clone())
    ref = [v.cpu() for v in leaves(params)]
    del params, state, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    # (c): rank 0 of the sharded cell on the one-card mesh, traced
    mesh = sharded_mesh()
    shape = ShapeConfig(f"train_{TRAIN_B}x{TRAIN_S}", StepKind.TRAIN,
                        TRAIN_S, TRAIN_B)
    tcfg = dataclasses.replace(cfg, shape=shape, param_dtype="float32")
    with dryrun.fake_card():            # its one-time set-up, as above
        pass
    with dryrun.fake_group(1):
        # the fake group's device mesh is set up before the trace's gates
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        fake_dm = device_mesh(mesh, "cuda")
        log(f"sharded (c): the fake group's device mesh: "
            f"{torch.cuda.max_memory_allocated() - alloc0} bytes at peak, "
            f"{torch.cuda.memory_allocated() - alloc0} kept")
        pred, trace_s = dryrun_no_device_work(
            "sharded (c) the one-rank cell", lambda: dryrun.trace_cell(
                arch, shape, mesh, tcfg, sharded=True, dmesh=fake_dm))
        del fake_dm
    marks.append(time.perf_counter())

    # the sharded steps over the one-rank NCCL mesh
    group()
    dm = device_mesh(mesh, "cuda")
    smodel = LMModel(arch, sequence_parallel=True, device=dev)
    params = smodel.init_params(seed=SEED)
    state = adamw.init(params, cfg.train)
    oshard = plan.opt_state_shardings(smodel, cfg, mesh, params, state)
    params = plan.distribute(params, plan.param_shardings(smodel, cfg, mesh),
                             dm)
    state = plan.distribute(state, oshard, dm)
    step_fn = train_loop.make_train_step(smodel, cfg,
                                         total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    launches, routed, step_ms, losses, rise, tracked = [], [], [], [], 0, None
    box = {}

    def first(*args):                   # step 0, under the dry run's counters
        box["out"] = step_fn(*args)
        return box["out"]
    for s in range(TRAIN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        common.reset_launches()                 # just before the step
        ev[0].record()
        if s == 0:
            tracked = dryrun.trace(first, (params, state, batches[s], s), dev)
            params, state, m = box.pop("out")
        else:
            params, state, m = step_fn(params, state, batches[s], s)
        ev[1].record()
        torch.cuda.synchronize()
        launches.append(dict(common.LAUNCHES))  # just after it
        routed.append(dict(common.SHARDED_CALLS))
        if s == 0:
            rise = torch.cuda.max_memory_allocated() - before
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss_bits = [torch.equal(a, b) for a, b in zip(losses, plain_losses)]
    differ = sum(not torch.equal(v.to_local(), r.to(dev))
                 for v, r in zip(leaves(params), ref))
    n_leaves = len(ref)
    marks.append(time.perf_counter())
    del params, state, m, step_fn, ref, losses
    gc.collect()
    torch.cuda.empty_cache()
    off = (pred["step_peak_bytes"] - rise) / rise
    rec = dict(
        arch=TRAIN_ARCH, batch=f"{TRAIN_B} x {TRAIN_S}",
        policy=SHARDED_POLICY, sequence_parallel=True,
        mesh="one NCCL rank, (data 1, model 1)",
        losses=[float(x) for x in plain_losses], loss_bits_equal=loss_bits,
        param_leaves_differing=differ, param_leaves=n_leaves,
        launches_per_step=[{n: c[n] for n in want} for c in launches],
        sharded_calls_per_step=routed, step_ms=step_ms,
        warm_step_ms=statistics.median(step_ms[1:]),
        peak_gib=peak,
        trace_s=trace_s, predicted_step_peak_bytes=pred["step_peak_bytes"],
        measured_step_peak_bytes=rise,
        tracked_real_step_peak_bytes=tracked["step_peak_bytes"],
        peak_rel_err=off, traced_collectives=pred["collectives"],
        real_collectives=tracked["collectives"],
        seconds=dict(unsharded=marks[1] - marks[0],
                     trace=marks[2] - marks[1],
                     sharded=marks[3] - marks[2]))
    log(f"sharded (a): {json.dumps(rec)}")
    if not all(loss_bits) or differ:
        raise AssertionError(f"sharded (a): losses bit-equal {loss_bits}, "
                             f"{differ} parameter leaves differ from the "
                             "unsharded steps")
    for i, got in enumerate(launches):
        if {n: got[n] for n in want} != want or got["wkv6"]:
            raise AssertionError(f"sharded (a): step {i} launched {got}, "
                                 f"want {want}")
        if not all(routed[i][n] for n in want):
            raise AssertionError(f"sharded (a): step {i} reached the "
                                 f"kernels' sharding rules {routed[i]}")
    if peak >= TRAIN_PEAK_GIB:
        raise AssertionError(f"sharded (a): peak {peak:.3f} GiB reaches "
                             f"{TRAIN_PEAK_GIB}")
    if abs(off) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"sharded (c): predicted step peak "
                             f"{pred['step_peak_bytes']} bytes, measured "
                             f"{rise}: {off:+.4f}, beyond {DRYRUN_PEAK_TOL}")
    return rec


def loss_and_grads(model, params, batch):
    """(``model``'s loss on ``batch``, the gradients of every leaf of
    ``params`` in ``leaves`` order), on plain tensors or DTensors alike;
    ``params`` is left as it is."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.optim.adamw import leaves
    xs = [v.detach().requires_grad_() for v in leaves(params)]
    it = iter(xs)

    def rebuild(tree):
        return {k: rebuild(tree[k]) if isinstance(tree[k], dict)
                else next(it) for k in sorted(tree)}
    with common.replicating(params):
        loss, _ = model.loss_fn(rebuild(params), batch)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), grads


def sharded_rwkv(dev):
    """(b): rwkv6-7b at RWKV_TRAIN_LAYERS of 32 layers, 1 x RWKV_TRAIN_S
    (the training phase's cut): a prefill and a loss with its backward,
    unsharded and through the sharded step on the open one-rank NCCL mesh;
    logits, loss and every gradient bit-equal. Returns the record."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, RunConfig,
                                         ShardingConfig)
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    arch = dataclasses.replace(get_arch(RWKV_ARCH),
                               n_layers=RWKV_TRAIN_LAYERS)
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    sharding=ShardingConfig(sequence_parallel=True))
    mesh = sharded_mesh()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, 1, RWKV_TRAIN_S, step=0, seed=SEED).items()}

    def run(model, params, b):
        logits, _ = model.prefill(params, {"tokens": b["tokens"]})
        return (logits.detach(),) + loss_and_grads(model, params, b)

    model = LMModel(arch, device=dev)
    params = model.init_params(seed=SEED)
    logits_u, loss_u, grads_u = run(model, params, batch)
    smodel = LMModel(arch, sequence_parallel=True, device=dev)
    dm = device_mesh(mesh, "cuda")
    dparams = plan.distribute(params, plan.param_shardings(smodel, cfg,
                                                           mesh), dm)
    bsh = plan.batch_specs(arch, dataclasses.replace(
        cfg.shape, global_batch=1, seq_len=RWKV_TRAIN_S), mesh)["shardings"]
    dbatch = plan.distribute(batch, {k: bsh[k] for k in batch}, dm)
    common.reset_launches()                     # just before the path
    logits_s, loss_s, grads_s = run(smodel, dparams, dbatch)
    torch.cuda.synchronize()
    launched, routed = dict(common.LAUNCHES), dict(common.SHARDED_CALLS)
    same_logits = torch.equal(logits_s.full_tensor(), logits_u)
    same_loss = torch.equal(loss_s.full_tensor(), loss_u)
    differ = sum(not torch.equal(g.full_tensor(), u)
                 for g, u in zip(grads_s, grads_u))
    rec = dict(arch=RWKV_ARCH, layers=RWKV_TRAIN_LAYERS,
               batch=f"1 x {RWKV_TRAIN_S}", logits_bits_equal=same_logits,
               loss_bits_equal=same_loss, grad_leaves_differing=differ,
               grad_leaves=len(grads_u), launches=launched,
               sharded_calls=routed)
    log(f"sharded (b): {json.dumps(rec)}")
    del params, dparams, grads_u, grads_s, logits_u, logits_s
    gc.collect()
    torch.cuda.empty_cache()
    if not (same_logits and same_loss) or differ:
        raise AssertionError(f"sharded (b): logits {same_logits}, loss "
                             f"{same_loss}, {differ} grads differ")
    if not launched["wkv6"] or not routed["wkv6"]:
        raise AssertionError(f"sharded (b): wkv6 launched {launched}, "
                             f"through its rule {routed}")
    return rec


def threaded_ranks(fn, world: int):
    """``fn(rank)`` on ``world`` threads of this process, each a rank of a
    threaded process group (the "threaded" backend of PyTorch's own
    distributed tests: a collective copies between the ranks' tensors, on
    any device; autograd runs each backward in its caller's thread), so
    that several ranks share the one card, which NCCL refuses and gloo
    does not do (its CUDA all-gather crashes in PyTorch 2.11). DTensor's
    implicit-replication flag is held on for the whole run: the port's
    entry points turn it on and off around themselves, and two ranks in
    one process would turn it off under each other. Returns the ranks'
    results; raises where a rank raised or did not end in
    SPLIT_TIMEOUT_S."""
    import threading
    import traceback
    import torch
    import torch.distributed as dist
    import torch.distributed.tensor.experimental as experimental
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    results, errors = [None] * world, []
    store = dist.HashStore()

    def rank_main(rank):
        DTensor._op_dispatcher._allow_implicit_replication = True
        dist.init_process_group("threaded", rank=rank, world_size=world,
                                store=store)
        # no destroy_process_group: PyTorch 2.11's fails on the threaded
        # world, which ``_uninstall_threaded_pg`` drops whole
        try:
            results[rank] = fn(rank)
        except BaseException as exc:
            errors.append((rank, traceback.format_exc()))
            mt.ProcessLocalGroup.exception_handle(exc)
    held = experimental.implicit_replication
    experimental.implicit_replication = contextlib.nullcontext
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    mt._install_threaded_pg()
    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + SPLIT_TIMEOUT_S
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
    finally:
        mt._uninstall_threaded_pg()
        mt.ProcessLocalGroup.reset()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        experimental.implicit_replication = held
        DTensor._op_dispatcher._allow_implicit_replication = False
    if errors:
        raise RuntimeError(f"rank {errors[0][0]} raised:\n{errors[0][1]}")
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"the ranks did not end in {SPLIT_TIMEOUT_S} s")
    return results


def split_case(dev, name, layers, sizes):
    """(d) for one model and mesh: ``name`` at ``layers`` layers and full
    width, SPLIT_B x SPLIT_S, on the (data, model) mesh of ``sizes``,
    model-parallel padding at its "model" size. First the unsharded
    kernel route in this thread: one loss and its gradients, then
    SPLIT_STEPS train steps from step 1; then the same through the sharded step on
    SPLIT_RANKS ranks (``threaded_ranks``), sequence parallel, policy
    SHARDED_POLICY, parameters, opt state and batch placed by the plan.
    The launches (of all ranks), the calls through the kernels' rules and
    the shapes each kernel was launched on (its first input's) are read
    around each part. Returns the record, each rank's worst differences
    from the unsharded route."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, PlacementPolicy,
                                         RunConfig, ShardingConfig,
                                         TrainConfig)
    from repro_torch.core.partitioning import MeshSpec
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.kernels.rwkv6_scan import ops as wk_ops
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import train_loop
    arch = dataclasses.replace(get_arch(name), n_layers=layers)
    mesh = MeshSpec(("data", "model"), sizes,
                    np.arange(SPLIT_RANKS).reshape(sizes))
    tp = sizes[1]
    cfg = RunConfig(arch=arch, shape=dataclasses.replace(
        LM_SHAPES["train_4k"], global_batch=SPLIT_B, seq_len=SPLIT_S),
        train=TrainConfig(warmup_steps=TRAIN_WARMUP),
        sharding=ShardingConfig(policy=PlacementPolicy(SHARDED_POLICY),
                                sequence_parallel=True))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, SPLIT_B, SPLIT_S, step=s, seed=SEED).items()}
        for s in range(SPLIT_STEPS)]
    def paths(tree, prefix=""):
        if not isinstance(tree, dict):
            return [prefix[:-1]]
        return [q for k in sorted(tree) for q in paths(tree[k],
                                                      f"{prefix}{k}/")]
    names = paths(LMModel(arch, tp=tp, device="meta").schema())
    shapes = {}
    spied = {"flash_attention": fa_ops, "rglru_scan": sc_ops,
             "wkv6": wk_ops}
    real = {n: m._launch for n, m in spied.items()}

    def spy(n):
        def launch(x, *args, **kwargs):
            shapes.setdefault(n, set()).add(tuple(x.shape))
            return real[n](x, *args, **kwargs)
        return launch

    def run(model, params, state, batch0):
        """(loss, grads, step losses, final params), as they lie."""
        loss, grads = loss_and_grads(model, params, batch0)
        step_fn = train_loop.make_train_step(model, cfg,
                                             total_steps=SPLIT_STEPS + 1)
        losses = []
        for s in range(SPLIT_STEPS):
            params, state, m = step_fn(params, state, batches[s], s + 1)
            losses.append(m["loss"])
        return loss, list(grads), losses, list(leaves(params))

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).double()

    def compare(got):
        """A rank's ``run`` against the unsharded one, leaf by leaf on the
        card: the largest |difference| over the largest |value| of the
        losses, and relative L2 distances of the grads (each leaf's and
        all) and of the parameters."""
        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        def sums(xs, ws):
            """[(squared distance, squared norm, max |difference|, max
            |value|)] a leaf."""
            out = []
            for x, w in zip(xs, ws):
                x, w = whole(x), w.double()
                out.append((float((x - w).square().sum()),
                            float(w.square().sum()),
                            float((x - w).abs().max()),
                            float(w.abs().max())))
            return out
        g, p = sums(got[1], want[1]), sums(got[3], want[3])
        worst = max(range(len(g)), key=lambda i: g[i][2] / g[i][3])
        return dict(
            loss_rel_err=rel(whole(got[0]), want[0].double()),
            step_loss_rel_err=max(rel(whole(x), w.double())
                                  for x, w in zip(got[2], want[2])),
            grad_l2_rel_err=(sum(t[0] for t in g)
                             / sum(t[1] for t in g)) ** 0.5,
            grad_leaf_l2_rel_err=max((t[0] / t[1]) ** 0.5 for t in g),
            grad_rel_err=g[worst][2] / g[worst][3],
            grad_worst_leaf=names[worst],
            param_rel_err=(sum(t[0] for t in p)
                           / sum(t[1] for t in p)) ** 0.5,
            param_abs_err=max(t[2] for t in p))

    def sharded(rank):
        dm = device_mesh(mesh, dev.type)
        smodel = LMModel(arch, tp=tp, sequence_parallel=True, device=dev)
        params = smodel.init_params(seed=SEED)
        state = adamw.init(params, cfg.train)
        oshard = plan.opt_state_shardings(smodel, cfg, mesh, params, state)
        params = plan.distribute(
            params, plan.param_shardings(smodel, cfg, mesh), dm)
        state = plan.distribute(state, oshard, dm)
        bsh = plan.batch_specs(arch, cfg.shape, mesh)["shardings"]
        return compare(run(smodel, params, state, plan.distribute(
            batches[0], {k: bsh[k] for k in batches[0]}, dm)))

    def counted(fn):
        """(fn(), launches, calls through the rules, launched shapes)."""
        shapes.clear()
        common.reset_launches()
        out = fn()
        return (out, {n: common.LAUNCHES[n] for n in spied},
                {n: common.SHARDED_CALLS[n] for n in spied},
                {n: sorted(v) for n, v in shapes.items()})

    for n, m in spied.items():
        m._launch = spy(n)
    try:
        model = LMModel(arch, tp=tp, device=dev)
        params = model.init_params(seed=SEED)
        want, want_launches, _, want_shapes = counted(lambda: run(
            model, params, adamw.init(params, cfg.train), batches[0]))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        got, launches, routed, got_shapes = counted(
            lambda: threaded_ranks(sharded, SPLIT_RANKS))
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for n, m in spied.items():
            m._launch = real[n]

    return dict(
        arch=name, layers=layers, mesh=dict(zip(("data", "model"), sizes)),
        loss=float(want[0]), leaves=len(want[3]), ranks=got,
        launches=launches, unsharded_launches=want_launches,
        sharded_calls=routed, local_shapes=got_shapes,
        unsharded_shapes=want_shapes)


def halved(shape, dim):
    return tuple(n // 2 if i == dim else n for i, n in enumerate(shape))


def sharded_split(dev):
    """(d): the sharded step on real splits, SPLIT_RANKS ranks sharing the
    one card (``split_case`` for each model of SPLIT_ARCHS on each mesh of
    SPLIT_MESHES). Gates, on every rank, model and mesh: the loss, the
    step losses, every gradient leaf and the parameters after the steps
    within SPLIT_LOSS_RTOL, SPLIT_GRAD_REL and SPLIT_PARAM_REL of the
    unsharded kernel route (relative L2 distances); each of the model's
    kernels launched, every call through its rule, and every launch on a
    local block: the unsharded launch's shape halved along the split dim
    (the batch under
    the data split; heads or width, dim 2, under the model split).
    Returns the records."""
    recs = []
    for name, layers, kernels in SPLIT_ARCHS:
        for sizes in SPLIT_MESHES:
            t0 = time.perf_counter()
            rec = split_case(dev, name, layers, sizes)
            rec["seconds"] = time.perf_counter() - t0
            log(f"sharded (d): {json.dumps(rec)}")
            recs.append(rec)
            label = f"sharded (d) {name} {rec['mesh']}"
            for r, e in enumerate(rec["ranks"]):
                if e["loss_rel_err"] > SPLIT_LOSS_RTOL or \
                        e["step_loss_rel_err"] > SPLIT_LOSS_RTOL or \
                        e["grad_leaf_l2_rel_err"] > SPLIT_GRAD_REL or \
                        e["param_rel_err"] > SPLIT_PARAM_REL:
                    raise AssertionError(f"{label}: rank {r} beyond the "
                                         f"unsharded route: {e}")
            dim = 0 if rec["mesh"]["data"] > 1 else 2
            for n in kernels:
                want = sorted(halved(s, dim)
                              for s in rec["unsharded_shapes"].get(n, ()))
                if not rec["unsharded_launches"][n] or \
                        not rec["launches"][n] or \
                        not rec["sharded_calls"][n] or \
                        rec["local_shapes"].get(n) != want:
                    raise AssertionError(
                        f"{label}: {n} launched {rec['launches'][n]} times "
                        f"({rec['unsharded_launches'][n]} unsharded), "
                        f"{rec['sharded_calls'][n]} through its rule, on "
                        f"{rec['local_shapes'].get(n)}, want {want}")
    return recs


@contextlib.contextmanager
def record_sharded_routing(store):
    """Wrap ``moe.moe_forward_sharded`` (here, never in the package) to
    record, for each call on each shard or rank, (its rank in the expert
    group, the tokens' expert ids (B, S_loc, k) from the layer's input and
    router, the assignments its owners drop)."""
    import torch
    from repro_torch.models import moe as moe_mod
    orig = moe_mod.moe_forward_sharded

    def wrapper(comm, p, x, arch):
        m = arch.moe
        T = x.shape[0] * x.shape[1]
        n = comm.n
        cap = max(8, -(-int(T * m.top_k / n * m.capacity_factor) // 8) * 8)
        with torch.no_grad():
            ids = expert_ids(x, p["router"], m.top_k)
            owner = ids.reshape(-1) // (m.n_experts // n)
            dropped = int(torch.clamp(torch.bincount(owner, minlength=n)
                                      - cap, min=0).sum())
        store.append(dict(rank=comm.rank, ids=ids, dropped=dropped))
        return orig(comm, p, x, arch)

    moe_mod.moe_forward_sharded = wrapper
    try:
        yield
    finally:
        moe_mod.moe_forward_sharded = orig


def routing_by_layer(store, n_layers, n_ranks):
    """``record_sharded_routing``'s records of one pass as ``routing_flips``
    takes them: each MoE layer's ids with the ranks' sequence blocks put
    together in rank order, and its drops summed over the ranks."""
    import torch
    calls = [[r for r in store if r["rank"] == k][:n_layers]
             for k in range(n_ranks)]
    return [dict(ids=torch.cat([calls[k][i]["ids"].cpu()
                                for k in range(n_ranks)], dim=1),
                 dropped=sum(calls[k][i]["dropped"] for k in range(n_ranks)))
            for i in range(n_layers)]


def sharded_moe_train(dev):
    """(e): phi3.5-moe at full width, MOE_SHARDED_LAYERS layers, 1 x
    MOE_SHARDED_S, sequence parallel, policy SHARDED_POLICY, TRAIN_STEPS
    train steps: first through ``LMModel(moe_mesh=VirtualMesh(1))`` (the
    bits to hold, kept on the host), then, on the open one-rank NCCL mesh,
    through the sharded step with ``moe_mesh`` the device mesh, parameters
    and opt state placed by the plan, the counts zeroed just before and
    read just after each step. Gates: losses and parameters bit-equal;
    every step's flash launches those of the unsharded step, each through
    its sharding rule, and every MoE layer through the DTensor dispatch;
    the peak under TRAIN_PEAK_GIB. Returns the record."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, PlacementPolicy,
                                         RunConfig, ShardingConfig,
                                         TrainConfig)
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import train_loop
    arch = dataclasses.replace(get_arch(MOE_ARCH),
                               n_layers=MOE_SHARDED_LAYERS)
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    train=TrainConfig(warmup_steps=TRAIN_WARMUP),
                    sharding=ShardingConfig(
                        policy=PlacementPolicy(SHARDED_POLICY),
                        sequence_parallel=True))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, 1, MOE_SHARDED_S, step=s, seed=SEED).items()}
        for s in range(TRAIN_STEPS)]
    marks = [time.perf_counter()]

    def steps(model, params, state, each=None):
        step_fn = train_loop.make_train_step(model, cfg,
                                             total_steps=TRAIN_STEPS)
        losses = []
        for s in range(TRAIN_STEPS):
            if each:
                each(s, "before")
            params, state, m = step_fn(params, state, batches[s], s)
            if each:
                each(s, "after")
            losses.append(m["loss"].clone())
        return params, losses

    model = LMModel(arch, moe_mesh=VirtualMesh(1, dev), device=dev)
    params = model.init_params(seed=SEED)
    common.reset_launches()
    params, plain_losses = steps(model, params, adamw.init(params,
                                                           cfg.train))
    want = common.LAUNCHES["flash_attention"] // TRAIN_STEPS
    plain_losses = [x.cpu() for x in plain_losses]
    ref = [v.cpu() for v in leaves(params)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    mesh = sharded_mesh()
    dm = device_mesh(mesh, "cuda")
    smodel = LMModel(arch, sequence_parallel=True, moe_mesh=dm,
                     expert_axes=("model",), device=dev)
    params = smodel.init_params(seed=SEED)
    state = adamw.init(params, cfg.train)
    oshard = plan.opt_state_shardings(smodel, cfg, mesh, params, state)
    params = plan.distribute(params, plan.param_shardings(smodel, cfg, mesh),
                             dm)
    state = plan.distribute(state, oshard, dm)
    dispatched = []
    orig = moe_mod.moe_forward_dtensor

    def counting(*args, **kwargs):
        dispatched.append(1)
        return orig(*args, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, routed, calls, step_ms = [], [], [], []
    ev = {}

    def each(s, when):
        if when == "before":
            dispatched.clear()
            common.reset_launches()             # just before the step
            ev[s] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[s][0].record()
            return
        ev[s][1].record()
        torch.cuda.synchronize()
        launches.append(common.LAUNCHES["flash_attention"])  # just after
        routed.append(dict(common.SHARDED_CALLS))
        calls.append(len(dispatched))
        step_ms.append(ev[s][0].elapsed_time(ev[s][1]))
    moe_mod.moe_forward_dtensor = counting
    try:
        params, losses = steps(smodel, params, state, each)
    finally:
        moe_mod.moe_forward_dtensor = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss_bits = [torch.equal(a.cpu(), b) for a, b in zip(losses,
                                                          plain_losses)]
    differ = sum(not torch.equal(v.to_local().cpu(), r)
                 for v, r in zip(leaves(params), ref))
    marks.append(time.perf_counter())
    n_leaves = len(ref)
    del params, state, ref
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(
        arch=MOE_ARCH, layers=MOE_SHARDED_LAYERS,
        batch=f"1 x {MOE_SHARDED_S}", experts=arch.moe.n_experts,
        top_k=arch.moe.top_k, d_expert=arch.moe.d_expert,
        capacity_factor=arch.moe.capacity_factor,
        mesh="one NCCL rank, (data 1, model 1)",
        losses=[float(x) for x in plain_losses], loss_bits_equal=loss_bits,
        param_leaves_differing=differ, param_leaves=n_leaves,
        flash_launches_per_step=launches, unsharded_flash_per_step=want,
        sharded_calls_per_step=routed, dtensor_dispatches_per_step=calls,
        step_ms=step_ms, warm_step_ms=statistics.median(step_ms[1:]),
        peak_gib=peak, seconds=dict(unsharded=marks[1] - marks[0],
                                    sharded=marks[2] - marks[1]))
    log(f"sharded (e): {json.dumps(rec)}")
    if not all(loss_bits) or differ:
        raise AssertionError(f"sharded (e): losses bit-equal {loss_bits}, "
                             f"{differ} parameter leaves differ from the "
                             "virtual-mesh route's steps")
    for i in range(TRAIN_STEPS):
        if launches[i] != want or not routed[i]["flash_attention"] or \
                calls[i] != 2 * MOE_SHARDED_LAYERS:
            raise AssertionError(
                f"sharded (e): step {i} launched flash {launches[i]} times "
                f"(want {want}), {routed[i]['flash_attention']} through its "
                f"rule, {calls[i]} DTensor dispatches (want "
                f"{2 * MOE_SHARDED_LAYERS}: forward and recompute)")
    if peak >= TRAIN_PEAK_GIB:
        raise AssertionError(f"sharded (e): peak {peak:.3f} GiB reaches "
                             f"{TRAIN_PEAK_GIB}")
    return rec


def block_views(tree, shardings, dm):
    """``tree``'s tensors as DTensors on ``dm`` whose local tensors are
    views of this rank's blocks of the whole tensors (no copy: the ranks of
    ``threaded_ranks`` share the whole tensors, read only)."""
    from repro_torch.core.partitioning import placements
    from repro_torch.launch.sharding_plan import _tree_map
    from torch.distributed.tensor import DTensor
    coord = dm.get_coordinate()

    def view(t, s):
        pl = placements(s.spec, s.mesh)
        local = t
        for i, q in enumerate(pl):
            if q.is_shard():
                k = local.shape[q.dim] // dm.size(i)
                local = local.narrow(q.dim, coord[i] * k, k)
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return _tree_map(view, tree, shardings)


def split_moe_case(dev, name, layers, train):
    """(f) for one model: ``name`` at ``layers`` layers and full width, 1 x
    SPLIT_MOE_S, on the (data 1, model 2) mesh, model-parallel padding 2,
    its experts over "model" (phi3.5-moe) or ("data", "model")
    (deepseek-v3, ``expert_parallel_data``). First the unsharded route
    (``moe_mesh=VirtualMesh(SPLIT_RANKS)``) in this thread: a forward
    (logits, aux), then a loss with its gradients and SPLIT_STEPS train
    steps from step 1 (``train``) or a forward ``loss_fn``; its results
    moved to the host. Then the same through the sharded step on
    SPLIT_RANKS ranks (``threaded_ranks``): parameters placed by the plan
    (for a model that only runs forward, views of the unsharded route's
    own parameters, which stay on the card: two copies of deepseek-v3's
    do not fit). The expert ids of each forward's MoE layers, the launches
    (of all ranks), the calls through the kernels' rules and the shapes
    flash launched on are read around each part. Returns the record, each
    rank's differences from the unsharded route."""
    import dataclasses
    import gc
    import threading
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import (LM_SHAPES, PlacementPolicy,
                                         RunConfig, ShardingConfig,
                                         TrainConfig)
    from repro_torch.core.partitioning import MeshSpec, P, named
    from repro_torch.core.vmesh import VirtualMesh
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import sharding_plan as plan
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import train_loop
    sizes = (1, SPLIT_RANKS)
    arch = dataclasses.replace(get_arch(name), n_layers=layers)
    epd = name == MLA_ARCH
    axes = ("data", "model") if epd else ("model",)
    mesh = MeshSpec(("data", "model"), sizes,
                    np.arange(SPLIT_RANKS).reshape(sizes))
    tp = sizes[1]
    cfg = RunConfig(arch=arch, shape=dataclasses.replace(
        LM_SHAPES["train_4k"], global_batch=1, seq_len=SPLIT_MOE_S),
        train=TrainConfig(warmup_steps=TRAIN_WARMUP),
        sharding=ShardingConfig(policy=PlacementPolicy(SHARDED_POLICY),
                                sequence_parallel=True,
                                expert_parallel_data=epd))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        arch, 1, SPLIT_MOE_S, step=s, seed=SEED).items()}
        for s in range(SPLIT_STEPS)]
    n_moe = layers - arch.moe.n_dense_layers
    shapes = set()
    real = fa_ops._launch

    def spy(x, *args, **kwargs):
        shapes.add(tuple(x.shape))
        return real(x, *args, **kwargs)

    def run(model, params, batch0, state=None):
        """(logits, aux, loss, grads, step losses, final params) on the
        card as they lie (grads and steps only with ``train``)."""
        with torch.no_grad():
            logits, _, aux = model.forward(params, {"tokens":
                                                    batch0["tokens"]})
        if not train:
            with torch.no_grad(), common.replicating(params):
                loss, _ = model.loss_fn(params, batch0)
            return logits, aux, loss, [], [], []
        loss, grads = loss_and_grads(model, params, batch0)
        step_fn = train_loop.make_train_step(model, cfg,
                                             total_steps=SPLIT_STEPS + 1)
        losses = []
        for s in range(SPLIT_STEPS):
            params, state, m = step_fn(params, state, batches[s], s + 1)
            losses.append(m["loss"])
        return logits, aux, loss, list(grads), losses, list(leaves(params))

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def counted(fn):
        shapes.clear()
        common.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return (out, common.LAUNCHES["flash_attention"],
                dict(common.SHARDED_CALLS), sorted(shapes))

    rec_u, rec_s = [], []
    fa_ops._launch = spy
    try:
        model = LMModel(arch, tp=tp, moe_mesh=VirtualMesh(SPLIT_RANKS, dev),
                        device=dev)
        params = model.init_params(seed=SEED)
        with record_sharded_routing(rec_u):
            want, want_launches, _, want_shapes = counted(lambda: run(
                model, params, batches[0],
                adamw.init(params, cfg.train) if train else None))
        want = [want[0].cpu(), want[1].cpu(), want[2].cpu(),
                [g.cpu() for g in want[3]], [x.cpu() for x in want[4]],
                [v.cpu() for v in want[5]]]
        if train:
            params = None
        gc.collect()
        torch.cuda.empty_cache()

        def rel(a, b):
            a, b = a.double(), b.double()
            return float((a - b).abs().max() / b.abs().max())

        def l2(xs, ws):
            """[(squared distance, squared norm)] a leaf, on the card in
            float64, up to 256 MiB of its rows at a time."""
            out = []
            for x, w in zip(xs, ws):
                x, w = whole(x).reshape(-1), w.reshape(-1)
                dist2 = norm2 = 0.0
                for lo in range(0, x.numel(), 1 << 25):
                    a = x[lo:lo + (1 << 25)].double()
                    b = w[lo:lo + (1 << 25)].to(dev).double()
                    dist2 += float((a - b).square().sum())
                    norm2 += float(b.square().sum())
                out.append((dist2, norm2))
            return out

        init_lock = threading.Lock()

        def sharded(rank):
            dm = device_mesh(mesh, dev.type)
            smodel = LMModel(arch, tp=tp, sequence_parallel=True,
                             moe_mesh=dm, expert_axes=axes, device=dev)
            pshard = plan.param_shardings(smodel, cfg, mesh)
            if train:
                # one rank at a time draws the whole parameters; the state
                # is made on the blocks, in the parameters' placements
                # (ZeRO-1's, the data axis being of one rank)
                with init_lock:
                    p = plan.distribute(smodel.init_params(seed=SEED),
                                        pshard, dm)
                    gc.collect()
                    torch.cuda.empty_cache()
                zeros = adamw._dtype(cfg.train.moment_dtype)
                state = adamw.AdamWState(
                    plan.distribute(torch.zeros((), dtype=torch.int32,
                                                device=dev),
                                    named(mesh, P()), dm),
                    adamw._map(lambda v: torch.zeros_like(v, dtype=zeros),
                               p),
                    adamw._map(lambda v: torch.zeros_like(v, dtype=zeros),
                               p),
                    adamw._map(lambda v: v.detach().to(torch.float32,
                                                       copy=True), p))
            else:
                p, state = block_views(params, pshard, dm), None
            bsh = plan.batch_specs(arch, cfg.shape, mesh)["shardings"]
            got = run(smodel, p, plan.distribute(
                batches[0], {k: bsh[k] for k in batches[0]}, dm), state)
            logits = whole(got[0]).cpu()
            out = dict(logits=logits, aux=float(whole(got[1])),
                       loss_rel_err=rel(whole(got[2]).cpu(), want[2]))
            if train:
                g, q = l2(got[3], want[3]), l2(got[5], want[5])
                out.update(
                    step_loss_rel_err=max(rel(whole(x).cpu(), w)
                                          for x, w in zip(got[4], want[4])),
                    grad_leaf_l2_rel_err=max((a / b) ** 0.5 for a, b in g),
                    grad_l2_rel_err=(sum(a for a, _ in g)
                                     / sum(b for _, b in g)) ** 0.5,
                    param_rel_err=(sum(a for a, _ in q)
                                   / sum(b for _, b in q)) ** 0.5)
            return out
        with record_sharded_routing(rec_s):
            got, launches, routed, got_shapes = counted(
                lambda: threaded_ranks(sharded, SPLIT_RANKS))
    finally:
        fa_ops._launch = real
    params = None
    gc.collect()
    torch.cuda.empty_cache()
    flips = routing_flips(routing_by_layer(rec_u, n_moe, SPLIT_RANKS),
                          routing_by_layer(rec_s, n_moe, SPLIT_RANKS))
    dropped = [max(a["dropped"], b["dropped"]) for a, b in zip(
        routing_by_layer(rec_u, n_moe, SPLIT_RANKS),
        routing_by_layer(rec_s, n_moe, SPLIT_RANKS))]
    reach = flip_reach(flips, dropped, 1, SPLIT_MOE_S)
    errs = []
    for r, e in enumerate(got):
        keep = ~reach[0]
        errs.append(held(e.pop("logits")[0][keep], want[0][0][keep],
                         SPLIT_MOE_LOGITS_TOL,
                         f"sharded (f) {name} rank {r} logits"))
        e["aux_rel_err"] = abs(e["aux"] - float(want[1])) / abs(
            float(want[1]))
    return dict(
        arch=name, layers=layers, batch=f"1 x {SPLIT_MOE_S}",
        mesh=dict(zip(("data", "model"), sizes)), expert_axes=axes,
        loss=float(want[2]), flips=len(flips), flip_positions=flips,
        dropped=dropped, held_shares=held_shares(reach),
        logits_errs=errs, ranks=got, launches=launches,
        unsharded_launches=want_launches, sharded_calls=routed,
        local_shapes=got_shapes, unsharded_shapes=want_shapes)


def sharded_moe_split(dev):
    """(f): the MoE and MLA families' sharded step on real splits,
    SPLIT_RANKS ranks sharing the one card (``split_moe_case`` for each
    of SPLIT_MOE_CASES). Gates, on every rank: at most MAX_FLIPS routing
    flips, each sequence held at MIN_HELD of its positions, the logits
    within SPLIT_MOE_LOGITS_TOL where no flip reaches; with no flip, the
    loss and the step losses within SPLIT_LOSS_RTOL, every gradient leaf
    within SPLIT_GRAD_REL and the parameters after the steps within
    SPLIT_PARAM_REL of the unsharded route (relative L2), the aux loss
    within SPLIT_LOSS_RTOL; flash launched on the halved heads (dim 2),
    every call through its rule. Returns the records."""
    recs = []
    for name, layers, train in SPLIT_MOE_CASES:
        t0 = time.perf_counter()
        rec = split_moe_case(dev, name, layers, train)
        rec["seconds"] = time.perf_counter() - t0
        rec["peak_gib"] = peak_line(f"sharded (f) {name}")
        log(f"sharded (f): {json.dumps(rec)}")
        recs.append(rec)
        label = f"sharded (f) {name}"
        flip_gate(rec["flip_positions"], rec["held_shares"], label)
        for r, e in enumerate(rec["ranks"]):
            if rec["flips"]:
                continue
            bad = [k for k, lim in (
                ("loss_rel_err", SPLIT_LOSS_RTOL),
                ("aux_rel_err", SPLIT_LOSS_RTOL),
                ("step_loss_rel_err", SPLIT_LOSS_RTOL),
                ("grad_leaf_l2_rel_err", SPLIT_GRAD_REL),
                ("param_rel_err", SPLIT_PARAM_REL)) if e.get(k, 0.0) > lim]
            if bad:
                raise AssertionError(f"{label}: rank {r} beyond the "
                                     f"unsharded route in {bad}: {e}")
        want = sorted(halved(s, 2) for s in rec["unsharded_shapes"])
        if not rec["unsharded_launches"] or not rec["launches"] or \
                not rec["sharded_calls"]["flash_attention"] or \
                rec["local_shapes"] != want:
            raise AssertionError(
                f"{label}: flash launched {rec['launches']} times "
                f"({rec['unsharded_launches']} unsharded), "
                f"{rec['sharded_calls']['flash_attention']} through its "
                f"rule, on {rec['local_shapes']}, want {want}")
    return recs


def sharded_phase(dev):
    """The sharded step on the card: (a) ``sharded_train``, (b)
    ``sharded_rwkv`` and (e) ``sharded_moe_train`` over one NCCL rank
    (NCCL puts one rank on a card), the trace of (a)'s cell, (c), inside
    ``sharded_train``; then (d) ``sharded_split`` and (f)
    ``sharded_moe_split``, two ranks sharing the card that split a mesh
    axis. Returns ({kernel: launches of (a)'s step and (b)}, the phase's
    numbers)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import dist as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(
            prefix="sharded_store_"), "store"), 1)

        def group():
            stack.enter_context(tdist.process_group(
                DP_BACKEND, rank=0, world_size=1, store=store,
                timeout=DP_GROUP_TIMEOUT))
            log(f"sharded: group up, backend {dist.get_backend()}, world "
                f"size {dist.get_world_size()}")
        a = sharded_train(dev, group)
        peak_line("sharded (a)")
        t_a = time.perf_counter()
        b = sharded_rwkv(dev)
        peak_line("sharded (b)")
        t_b = time.perf_counter()
        e = sharded_moe_train(dev)
        peak_line("sharded (e)")
    t_e = time.perf_counter()
    d = sharded_split(dev)
    t_d = time.perf_counter()
    f = sharded_moe_split(dev)
    peak_line("sharded (f)")
    t_end = time.perf_counter()
    log(f"sharded phase: {t_end - t0:.3f} s ((a) {t_a - t0:.3f}, (b) "
        f"{t_b - t_a:.3f}, (e) {t_e - t_b:.3f}, (d) {t_d - t_e:.3f}, (f) "
        f"{t_end - t_d:.3f})")
    launches = {n: a["launches_per_step"][-1][n]
                for n in ("flash_attention", "rglru_scan")}
    launches["wkv6"] = b["launches"]["wkv6"]
    return launches, dict(train=a, rwkv=b, moe_train=e, split=d,
                          moe_split=f, seconds=t_end - t0)


def pod_reports_phase():
    """(c)'s pod-mesh reports, after every timed phase: ``run_cell`` of
    each of SHARDED_POD_CELLS with the CLI's H100 SXM data-sheet rates
    (rank 0 of the sharded step traced under a fake group of the mesh's
    size, the whole step's trace beside it), predictions one card cannot
    check. Raises where a report lacks its temporaries, ``fits`` or
    collective bytes. Returns the reports' main fields."""
    from repro_torch.launch import dryrun
    keys = ("arch", "shape", "mesh", "status", "trace_s",
            "temp_bytes_per_device", "bytes_per_device", "fits",
            "collective_operand_bytes_per_device",
            "collective_wire_bytes_per_device", "roofline", "rates")
    t0 = time.perf_counter()
    reps = []
    for arch, shape, multi in SHARDED_POD_CELLS:
        rep = dryrun.run_cell(arch, shape, multi_pod=multi,
                              rates_source=dryrun.H100_SXM_SOURCE,
                              verbose=False, **dryrun.H100_SXM)
        rep = {k: rep.get(k) for k in keys}
        log("sharded (c), a prediction one card cannot check (the CLI's H100 "
            f"SXM data-sheet rates): {json.dumps(rep)}")
        if rep["status"] != "ok" or rep["fits"] is None or \
                rep["collective_wire_bytes_per_device"] is None:
            raise AssertionError(f"sharded (c): {rep}")
        reps.append(rep)
    log(f"sharded (c) pod-mesh reports: {time.perf_counter() - t0:.3f} s")
    return reps


# ---------------------------------------------------------------------------
# the host's cost of a call of the three LM kernels, layer by layer
# ---------------------------------------------------------------------------
HOST_COST_ROUNDS, WAVE_ROUNDS = 5, 3
WAVE_B, WAVE_CAP = 8, 256


def host_cost(dev):
    """Host us a call of the three LM kernels at small inputs, where the
    host's issue bounds a call (``host_us``; the median of
    HOST_COST_ROUNDS rounds, the layers timed in turns within a round),
    layer by layer: the wrapper (``flash_attention``, ``linear_scan``,
    ``wkv6``, under no_grad); its ``_launch`` (the checks and the launch);
    where the launch is a ``torch.library`` operator, the operator
    (``torch.ops.repro_torch.*``) and its CUDA implementation called as a
    plain function. Then the ms of a recurrentgemma-2b decode wave (B 8,
    cache 256, fp32 weights from SEED; ``cuda_ms`` of 10 waves, the median
    of WAVE_ROUNDS rounds). The port timed is the one on ``sys.path``, so
    that ``--host-cost SRC`` times another checkout's in the same way."""
    import statistics
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import linear_scan
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.kernels.rwkv6_scan import ops as wk_ops
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.models.lm import LMModel
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    q, k, v = rand(1, 16, 8, 64), rand(1, 16, 2, 64), rand(1, 16, 2, 64)
    a = torch.rand(1, 16, 256, device=dev, generator=gen)
    b = rand(1, 16, 256)
    wkv_args = (rand(1, 16, 2, 64), rand(1, 16, 2, 64), rand(1, 16, 2, 64),
                torch.rand(1, 16, 2, 64, device=dev, generator=gen),
                rand(2, 64))
    layers = {
        "flash_attention": {
            "wrapper": lambda: flash_attention(q, k, v),
            "launch": lambda: fa_ops._launch(q, k, v, causal=True,
                                             window=None, q_offset=0,
                                             scale=0.125)},
        "rglru_scan": {"wrapper": lambda: linear_scan(a, b),
                       "launch": lambda: sc_ops._launch(a, b)},
        "wkv6": {"wrapper": lambda: wkv6(*wkv_args),
                 "launch": lambda: wk_ops._launch(*wkv_args)}}
    if hasattr(torch.ops.repro_torch, "flash_attention_fwd"):
        nc = -(-a.shape[1] // (sc_ops.WARPS * sc_ops.CHUNK))
        words = torch.empty(a.shape[0] * nc * a.shape[2] + 1,
                            dtype=torch.int64, device=dev)
        ops = torch.ops.repro_torch
        layers["flash_attention"].update(
            operator=lambda: ops.flash_attention_fwd(q, k, v, True, -1, 0,
                                                     0.125),
            function=lambda: fa_ops._cuda_fwd(q, k, v, True, -1, 0, 0.125))
        layers["rglru_scan"].update(
            operator=lambda: ops.rglru_scan_fwd(a, b, words, sc_ops.CHUNK),
            function=lambda: sc_ops._cuda_fwd(a, b, words, sc_ops.CHUNK))
        layers["wkv6"].update(
            operator=lambda: ops.wkv6_fwd(*wkv_args),
            function=lambda: wk_ops._cuda_fwd(*wkv_args))
    out = {}
    with torch.no_grad():
        for name, fns in layers.items():
            runs = {layer: [] for layer in fns}
            for _ in range(HOST_COST_ROUNDS):
                for layer, fn in fns.items():
                    runs[layer].append(host_us(fn))
            out[name] = {layer: statistics.median(t)
                         for layer, t in runs.items()}
        arch = get_arch(LM_ARCH)
        model = LMModel(arch, device=dev)
        params = model.init_params(seed=SEED)
        cache = model.init_cache(WAVE_B, WAVE_CAP, fill_len=WAVE_CAP // 2)
        tokens = torch.randint(1, arch.vocab_size, (WAVE_B, 1), device=dev,
                               dtype=torch.int32, generator=gen)
        wave = statistics.median(cuda_ms(
            lambda: model.decode_step(params, cache, {"tokens": tokens}),
            reps=10) for _ in range(WAVE_ROUNDS))
    del model, params, cache
    return dict(host_us=out, decode_wave_ms=wave,
                decode_wave=f"{LM_ARCH}, B {WAVE_B}, cache {WAVE_CAP}")


def host_cost_main(src: str) -> int:
    """``--host-cost SRC``: build the three LM kernels of the port under
    SRC (a checkout's ``src``) and print ``host_cost`` of it as one JSON
    line, then the card's name and power limit. Run it on two checkouts in
    turns (parent, change, change, parent) to compare them on one card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import build
    build.build(["flash_attention", "rglru_scan", "rwkv6_scan"])
    torch.backends.cuda.matmul.allow_tf32 = False
    numbers = host_cost(torch.device("cuda"))
    print("host_cost " + json.dumps(dict(numbers, src=src,
                                         torch=torch.__version__)))
    print(card_line())
    return 0


def peak_line(label: str) -> float:
    """Print the phase's peak device memory in GiB, reset the counter and
    return the peak."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak memory [{label}]: {peak:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    return peak


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
    imp_launches, wrapper_time = paper_axes_phase(data, oracle, aggs["q18"],
                                                  card)
    peak_line("paper axes")

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
    svc_launches, svc_agg, svc_agg_err = service_phase(data, results, oracle)
    svc_agg_time = dict(time_hash_aggregate(
        *svc_agg, f"one served q1 morsel of {SERVE_MORSEL_ROWS} rows, SF1"),
        max_abs_err=svc_agg_err)
    log(f"hash_aggregate service morsel timing {json.dumps(svc_agg_time)}")
    calib_launches, calib_report = calibration_phase(data, results["plain"],
                                                     oracle)
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
    torch.cuda.reset_peak_memory_stats()
    train_launches, train_times, grad_errs, train_numbers = train_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    dp_launches, dp_numbers = dp_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    for row in lm_kernels:
        row["launches_dp_step"] = dp_launches[row["name"]]
        row["launches_dp_virtual_mesh_step"] = dp_numbers["virtual_mesh"][
            "launches_per_step"][row["name"]]
    lm_kernels[0]["launches_dp_moe_mesh"] = dp_numbers["moe_mesh"][
        "launches"]
    for row in lm_kernels + [wkv_kernel]:
        row["launches_train_step"] = train_launches[row["name"]]
    lm_kernels[0].update(backward=dict(
        train_times["flash_attention"], route="plain torch (the reference's "
        "chunked recompute)", grad_rel_err=grad_errs[
            "flash_attention full width"]))
    lm_kernels[1].update(backward=dict(
        train_times["rglru_scan"], route="the same CUDA kernel, reversed",
        grad_rel_err=grad_errs["rglru_scan full width"]))
    wkv_kernel.update(
        backward=dict(route="autograd through wkv6_ref (bit-equal)"),
        launches_train_step_note=f"{RWKV_ARCH}, {RWKV_TRAIN_LAYERS} of 32 "
        f"layers, one loss and backward at 1 x {RWKV_TRAIN_S}")
    t_new = time.perf_counter()
    moe_fa, moe_numbers = moe_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    vlm_fa, audio_fa = families_phase(dev)
    log(f"moe and families phases: {time.perf_counter() - t_new:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    mla_fa, mla_numbers = mla_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    dryrun_numbers = dryrun_phase(dev)
    torch.cuda.reset_peak_memory_stats()
    sharded_launches, sharded_numbers = sharded_phase(dev)
    sharded_numbers["train"].update(
        unsharded_step_ms=train_numbers["step_ms"],
        unsharded_peak_gib=train_numbers["peak_gib"])
    log(f"sharded (a) beside the training phase's unsharded step: ms a step "
        f"{sharded_numbers['train']['warm_step_ms']!r} vs "
        f"{train_numbers['step_ms']!r}, peak GiB "
        f"{sharded_numbers['train']['peak_gib']!r} vs "
        f"{train_numbers['peak_gib']!r}")
    for row in lm_kernels + [wkv_kernel]:
        row["launches_sharded"] = sharded_launches[row["name"]]
    lm_kernels[0].update(
        launches_sharded_moe_step=sharded_numbers["moe_train"][
            "flash_launches_per_step"][-1],
        launches_sharded_moe_split={
            r["arch"]: r["launches"] for r in sharded_numbers["moe_split"]},
        sharded_moe_split_shapes={
            r["arch"]: r["local_shapes"] for r in sharded_numbers["moe_split"]})
    host_numbers = host_cost(dev)
    log(f"host cost: {json.dumps(host_numbers)}")
    # the last timed phase is over: the CPU-bound traces come after it
    sharded_numbers["pod_reports"] = pod_reports_phase()
    lm_kernels[0].update(
        launches_moe_prefill=moe_fa.pop("launches"),
        launches_moe_train=moe_fa.pop("launches_train"),
        launches_vlm_prefill=vlm_fa.pop("launches"),
        launches_audio_prefill=audio_fa.pop("launches"),
        launches_mla_prefill=mla_fa.pop("launches"),
        launches_mla_loss=mla_fa.pop("launches_loss"),
        family_shapes=[moe_fa, vlm_fa, audio_fa, mla_fa])
    log("flash_attention ms / SDPA ms, per prefill shape: " + "; ".join(
        f"{r['shape'].split(':')[0]} {r['ms'] / r['library_ms']!r}"
        for r in (lm_kernels[0], moe_fa, vlm_fa, audio_fa, mla_fa)))

    head = agg_times["q18"]
    kernels = [
        dict(name="hash_aggregate_multi", route="cuda",
             source="src/repro_torch/kernels/csrc/hash_aggregate.cu",
             replaces="src/repro/kernels/hash_aggregate/kernel.py:54",
             launches=launches["hash_aggregate_multi"], **head,
             launches_distributed=dist_launches["hash_aggregate_multi"],
             launches_telemetry=tele_launches["hash_aggregate_multi"],
             launches_w_one_device=w_launches["hash_aggregate_multi"],
             launches_service=svc_launches["hash_aggregate_multi"],
             launches_calibration=calib_launches["hash_aggregate_multi"],
             launches_imperative=imp_launches["hash_aggregate_multi"],
             service_morsel_shape=svc_agg_time, wrapper_shape=wrapper_time,
             other_shapes=[agg_times["q1"], dist_agg_time, w_agg_time]),
        dict(name="join_probe", route="cuda",
             source="src/repro_torch/kernels/csrc/join_probe.cu",
             replaces="src/repro/kernels/join_probe/kernel.py:40",
             launches=launches["join_probe"], max_abs_err=probe_err,
             launches_telemetry=tele_launches["join_probe"],
             launches_w_one_device=w_launches["join_probe"],
             launches_service=svc_launches["join_probe"],
             **probe_time, other_shapes=[w_probe_time]),
        dict(name="block_histograms", route="cuda",
             source="src/repro_torch/kernels/csrc/radix_partition.cu",
             replaces="src/repro/kernels/radix_partition/kernel.py:35",
             launches=dist_launches["block_histograms"], max_abs_err=0.0,
             launches_telemetry=tele_launches["block_histograms"],
             launches_service=svc_launches["block_histograms"],
             launches_calibration=calib_launches["block_histograms"],
             **radix_time),
    ] + lm_kernels + [wkv_kernel]
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print("sharded " + json.dumps(sharded_numbers))
    print("dryrun " + json.dumps(dryrun_numbers))
    print("host_cost " + json.dumps(host_numbers))
    print("mla " + json.dumps(mla_numbers))
    print("moe " + json.dumps(moe_numbers))
    print("train " + json.dumps(train_numbers))
    print("dp " + json.dumps(dp_numbers))
    print("calibration " + json.dumps(calib_report))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--host-cost"]:
            sys.exit(host_cost_main(sys.argv[2] if len(sys.argv) > 2
                                    else os.path.join(ROOT, "src")))
        sys.exit(main())
    except Exception as exc:            # any failed phase: no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
