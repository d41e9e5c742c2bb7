#!/usr/bin/env python
"""Gate for request-scoped tracing in the port's serving tier: the
scenario of ``scripts/trace_gate.py`` on ``repro_torch``.

Serves a traced multi-tenant chaos round (scheduled build failure + wait
poison + mid-round pool kill, morsel-split over two pools with stealing),
plus one traced whole-plan compile+execute for the plan-level spans, and
exits non-zero if any contract is broken:

  1. the exported Chrome trace is valid JSON with >= 6 distinct phase
     names and populated pool/worker lanes (pid lanes beyond "service");
  2. no span is left open after the round (span conservation);
  3. every completed request's phase attribution (queue_wait/batch_wait/
     retry_backoff/execute/merge) sums to <= its wall latency, and
     ServiceStats reports a populated per-class p99 decomposition;
  4. every injected fault produced a NON-EMPTY flight-recorder dump; a
     fault of one request (build failure, wait poison) holds that
     request's spans, and no dump holds an operator span;
  5. zero-cost-when-disabled: an identical untraced round allocates NO
     spans (``Tracer.created`` unchanged), and flipping the tracing flag
     does not change the plan-cache key (no re-lowering).

It then checks that a traced split-probe q3 leaves one ``morsel.run``
span per dispatched morsel. The reference forces 4 fake host devices for
its pools' shard ranges; the port's tables lie on one device and need
none. Runs on the card by default (and raises when there is none), or on
the CPU with ``--device cpu``:

    PYTHONPATH=src python scripts/trace_gate_torch.py [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.analytics import planner, tracing  # noqa: E402
from repro_torch.analytics.service import (AnalyticsService,  # noqa: E402
                                           RetryPolicy, ServiceConfig,
                                           ServiceFaultInjector,
                                           ThreadPlacement)
from repro_torch.analytics.service.service import PHASES  # noqa: E402
from repro_torch.analytics.tpch import (LOGICAL_QUERIES,  # noqa: E402
                                        generate, submit_query)
from repro_torch.core.config import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the tables lie: cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    data = generate(scale=0.004, seed=1, device=dev)
    tables = data.tables
    ctx = planner.ExecutionContext(executor="xla")

    def config(faults=None):
        return ServiceConfig(
            n_pools=2, workers_per_pool=2, morsel_rows=997,
            placement=ThreadPlacement.SPARSE, faults=faults,
            retry=RetryPolicy(max_attempts=4, base_backoff_s=0.002,
                              max_backoff_s=0.02))

    def serve_round(faults=None):
        """Three waves of the seven TPC-H plans across three tenants and
        two priority classes; waves advance dispatch ordinals past the
        fault schedule (identical requests dedup into ONE share)."""
        results, rids = {}, []
        with AnalyticsService(config(faults)) as svc:
            for _ in range(3):
                rids += [submit_query(svc, n, data, context=ctx,
                                      client_id=i % 3, priority=1 + i % 2)
                         for i, n in enumerate(LOGICAL_QUERIES)]
                results.update(svc.drain())
            st = svc.stats()
        return rids, results, st

    # -- 0. warm the plan cache untraced, then measure the traced round --
    planner.clear_plan_cache()
    serve_round()
    tracing.tracer().clear()

    faults = ServiceFaultInjector(seed=3, build_fail_at={6},
                                  poison_wait_at={8}, kill_pool_at=(11, 1))
    with tracing.tracing() as tr:
        rids, results, st = serve_round(faults)
        # whole-plan compile+execute for the plan-level spans (the
        # morsel-split service path never dispatches a whole CompiledPlan);
        # the cache is cleared so the compile is a genuine miss
        q6 = LOGICAL_QUERIES["q6"]
        planner.clear_plan_cache()
        planner.compile_plan(q6, tables, ctx)(tables)
        open_left = tr.open_spans()
        dumps = tr.flight.dumps()
        path = os.path.join(tempfile.mkdtemp(prefix="trace_gate_"),
                            "round.trace.json")
        tr.trace().save(path)
        trace = tr.trace()

    fired = (faults.builds_failed + faults.waits_poisoned
             + faults.pools_killed)
    if fired != 3:
        print(f"trace_gate_torch: FAIL — expected all 3 scheduled faults to "
              f"fire, got {fired} (builds={faults.builds_failed} "
              f"poisons={faults.waits_poisoned} "
              f"kills={faults.pools_killed}); the wave structure no "
              "longer advances dispatch ordinals past the schedule")
        return 1

    # -- 1. chrome trace: valid JSON, >= 6 phases, pool lanes populated --
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    if not events:
        print("trace_gate_torch: FAIL — exported Chrome trace has no events")
        return 1
    names = {e["name"] for e in events if e["ph"] in ("X", "i")}
    if len(names) < 6:
        print(f"trace_gate_torch: FAIL — only {len(names)} distinct phase "
              f"names in the Chrome trace: {sorted(names)}")
        return 1
    pool_lanes = {p for p, _ in trace.lanes() if p.startswith("pool")}
    if not pool_lanes:
        print("trace_gate_torch: FAIL — no pool/worker lanes in the trace "
              f"(lanes: {trace.lanes()})")
        return 1
    needed = {"queue.wait", "dispatch.build", "morsel.run",
              "merge.partials", "result.deliver", "retry.backoff",
              "plan.compile", "plan.execute"}
    missing = needed - names
    if missing:
        print(f"trace_gate_torch: FAIL — serving-path phases missing from the "
              f"trace: {sorted(missing)}")
        return 1
    print(f"trace_gate_torch: chrome trace OK ({len(events)} events, "
          f"{len(names)} phases, pool lanes {sorted(pool_lanes)}) "
          f"-> {path}")

    # -- 2. span conservation ------------------------------------------------
    if open_left:
        print(f"trace_gate_torch: FAIL — {len(open_left)} spans left OPEN "
              f"after the round: "
              f"{[(o.name, o.trace_id) for o in open_left]}")
        return 1

    # -- 3. latency attribution ----------------------------------------------
    completed = [r for r in results.values() if r.value is not None]
    if not completed:
        print("trace_gate_torch: FAIL — chaos round completed no requests")
        return 1
    for res in completed:
        if res.phases is None or set(res.phases) != set(PHASES):
            print(f"trace_gate_torch: FAIL — request {res.req_id} missing "
                  f"phase attribution: {res.phases}")
            return 1
        total = sum(res.phases.values())
        if total > res.latency_s + 1e-6:
            print(f"trace_gate_torch: FAIL — request {res.req_id} phase sum "
                  f"{total:.6f}s exceeds wall {res.latency_s:.6f}s: "
                  f"{res.phases}")
            return 1
    classes = [p for p, cs in st.per_class.items() if cs.phase_p99_ms]
    if not classes or st.phase_p99_ms.get("execute", 0.0) <= 0.0:
        print(f"trace_gate_torch: FAIL — p99 decomposition not populated "
              f"(service={st.phase_p99_ms}, classes={classes})")
        return 1
    print(f"trace_gate_torch: attribution OK ({len(completed)} completed; "
          f"p99 ms " + " ".join(f"{k}={st.phase_p99_ms[k]:.2f}"
                                for k in PHASES)
          + f"; classes {sorted(classes)})")

    # -- 4. flight recorder: one non-empty dump per injected fault ----------
    fault_dumps = [d for d in dumps if d.reason.startswith("fault.")]
    if len(fault_dumps) != fired:
        print(f"trace_gate_torch: FAIL — {fired} faults fired but "
              f"{len(fault_dumps)} flight dumps recorded: "
              f"{[d.reason for d in dumps]}")
        return 1
    empty = [d.reason for d in fault_dumps if not d.spans]
    if empty:
        print(f"trace_gate_torch: FAIL — EMPTY flight dumps for {empty}")
        return 1
    # a request's fault: its dump holds that request's serving spans (the
    # dispatch.build it tripped in, open), and no operator span crowds
    # them out of the window
    for d in fault_dumps:
        rid = d.args.get("trace_id")
        if d.reason == "fault.pool_kill":
            continue
        mine = [s.name for s in d.spans if s.trace_id == rid]
        if rid is None or rid < 0 or "dispatch.build" not in mine:
            print(f"trace_gate_torch: FAIL — {d.reason} dump lacks the "
                  f"faulted request's spans (request {rid}, its spans "
                  f"{mine})")
            return 1
    walk = [d.reason for d in dumps
            if any(s.cat in ("op", "sync") for s in d.spans)]
    if walk:
        print(f"trace_gate_torch: FAIL — operator spans in flight dumps "
              f"{walk}")
        return 1
    print(f"trace_gate_torch: flight recorder OK "
          f"({[d.reason for d in fault_dumps]}, "
          f"{[len(d.spans) for d in fault_dumps]} spans)")

    # -- 5. zero-cost when disabled + cache-key stability --------------------
    before = tracing.tracer().created
    serve_round()
    after = tracing.tracer().created
    if after != before:
        print(f"trace_gate_torch: FAIL — untraced round allocated "
              f"{after - before} spans; a hot-path hook is missing its "
              "tracing_enabled() guard")
        return 1
    off_key = planner.compile_plan(q6, tables, ctx).cache_key
    tracing.enable_tracing()
    try:
        h0 = planner.plan_cache_info().hits
        on = planner.compile_plan(q6, tables, ctx)
    finally:
        tracing.disable_tracing()
    if on.cache_key != off_key or planner.plan_cache_info().hits != h0 + 1:
        print("trace_gate_torch: FAIL — tracing flag leaked into the "
              "plan-cache key (flipping it re-lowered the plan)")
        return 1
    print("trace_gate_torch: zero-overhead OK (untraced round allocated 0 "
          "spans; tracing flag not in the plan-cache key)")

    # -- 6. split-probe morsel spans ----------------------------------------
    # one traced q3 through a fresh service: the probe side splits into
    # per-pool morsels, and the trace must carry one morsel.run span PER
    # dispatched morsel, tied to the request, with the request's phase
    # attribution still summing to <= its wall latency (morsels overlap
    # across pools, so execute is wall-clock, not a per-morsel sum)
    tracing.tracer().clear()
    with tracing.tracing() as tr:
        with AnalyticsService(config()) as svc:
            rid = submit_query(svc, "q3", data, context=ctx)
            res3 = svc.drain()[rid]
            st3 = svc.stats()
        spans = tr.trace().spans
    morsel_spans = [s for s in spans
                    if s.name == "morsel.run" and s.trace_id == rid]
    if len(morsel_spans) < 2:
        print(f"trace_gate_torch: FAIL — split-probe q3 produced only "
              f"{len(morsel_spans)} morsel.run spans (probe did not "
              "split, or spans lost their trace_id)")
        return 1
    if len(morsel_spans) != st3.morsels:
        print(f"trace_gate_torch: FAIL — scheduler dispatched {st3.morsels} "
              f"morsels but the trace has {len(morsel_spans)} morsel.run "
              "spans (one span per split probe morsel)")
        return 1
    pools = {s.pid for s in morsel_spans}
    if res3.value is None or res3.phases is None:
        print(f"trace_gate_torch: FAIL — traced split-probe request failed: "
              f"{res3.error}")
        return 1
    total3 = sum(res3.phases.values())
    if total3 > res3.latency_s + 1e-6:
        print(f"trace_gate_torch: FAIL — split-probe request phase sum "
              f"{total3:.6f}s exceeds wall {res3.latency_s:.6f}s: "
              f"{res3.phases}")
        return 1
    print(f"trace_gate_torch: split-probe spans OK ({len(morsel_spans)} "
          f"morsel.run spans across pools {sorted(pools)}; phase sum "
          f"{total3 * 1e3:.2f}ms <= wall {res3.latency_s * 1e3:.2f}ms)")
    print("trace_gate_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
