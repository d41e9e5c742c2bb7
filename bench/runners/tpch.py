"""Served TPC-H: closed-loop query streams through one AnalyticsService.

Each stream is a client thread that submits its next query, waits for
the result and copies it to the host, then submits the next; the
service runs in its always-on mode (``start()``) under the mix's
``service`` settings (the default ``ServiceConfig`` when empty). A
request is timed on the client's side, from ``submit`` to its result
being in host memory. The streams submit nothing after the window
closes; the requests still open then are waited for. The rate counts the
queries completed inside the window; the tail takes every request
submitted in it, those that finish after the close too.

Correctness: every answer of the window, those that came after its
close too, is judged against the plain reference, worked out once for
each distinct (query, parameters).
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import compare, queries, stats, traffic_gen
from bench.datagen.tpch import make_tables, table_bytes
from bench.reference.tpch import Reference


@dataclass
class Request:
    key: queries.Key
    t0: float
    t1: float = 0.0
    value: Optional[Dict[str, np.ndarray]] = None
    error: Optional[str] = None
    service_latency_s: float = 0.0
    phases: Optional[Dict[str, float]] = None


@dataclass
class Window:
    t_open: float
    t_close: float
    requests: List[Request] = field(default_factory=list)


def to_host(value) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in value.items()}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.service = None
        self.window: Optional[Window] = None

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.analytics.planner import ExecutionContext
        from repro_torch.analytics.service import (AnalyticsService,
                                                   ServiceConfig)
        self.tables = make_tables(self.config["rows"], self.seed,
                                  self.device)
        print(f"tpch: {table_bytes(self.tables) / 1e9:.3f} GB of tables "
              f"on {self.device}", file=sys.stderr)
        self.ctx = ExecutionContext(executor=self.config["executor"])
        if self.device.type == "cuda":
            # built and loaded before the service starts: a build inside
            # the first served morsel would count toward its pool's
            # service time, and the straggler detector would quarantine
            # that pool for the rest of the process (PERF.md, section 7)
            from repro_torch.kernels import build
            for name in ("hash_aggregate", "join_probe"):
                build.library(name)
        self.service = AnalyticsService(
            ServiceConfig(**self.traffic.get("service", {})))
        self.service.start()
        n = int(self.traffic["streams"])
        per = len(self.traffic["queries"]) * int(
            self.traffic.get("warmup_passes", 1))
        warm = [traffic_gen.warmup_stream(self.traffic, self.seed, i)
                for i in range(n)]
        self._clients(lambda i: [self.request(*next(warm[i]))
                                 for _ in range(per)], n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.report_pools("after set-up")

    def report_pools(self, when: str) -> None:
        """The service's pool health on standard error: a pool that its
        straggler detector quarantined serves nothing for the rest of the
        process."""
        s = self.service.scheduler.stats()
        print(f"tpch: pools {when}: quarantined {list(s.quarantined_pools)}"
              f", requeued {s.requeued}, morsels a pool "
              f"{list(s.executed_per_pool)}, EWMA ms "
              f"{[round(t * 1e3, 1) for t in s.pool_ewma_s]}",
              file=sys.stderr)

    def _clients(self, body, n: int, timeout: Optional[float] = None):
        out: List = [None] * n
        errors: List[BaseException] = []

        def run(i):
            try:
                out[i] = body(i)
            except BaseException as e:      # re-raised in the caller
                errors.append(e)
        threads = [threading.Thread(target=run, args=(i,),
                                    name=f"bench-stream-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not finish")
        if errors:
            raise errors[0]
        return out

    # -- one request ----------------------------------------------------------
    def request(self, name: str, params: Dict[str, int]) -> Request:
        plan = queries.plan(name, params)
        req = Request(queries.key(name, params), time.perf_counter())
        rid = self.service.submit(plan, self.tables, context=self.ctx)
        if rid is None:
            req.error, req.t1 = "refused (backpressure)", time.perf_counter()
            return req
        res = self.service.result(rid, timeout=self.config.get(
            "request_timeout_s", 120.0))
        if res is None:
            req.error = "no result"
        elif res.value is None:
            req.error = res.error or ("expired" if res.expired else "shed")
        else:
            req.value = to_host(res.value)
            req.service_latency_s = res.latency_s
            req.phases = res.phases
        req.t1 = time.perf_counter()
        return req

    # -- the window -----------------------------------------------------------
    def run(self, seconds: float, tracer=None) -> dict:
        from repro_torch.analytics import planner
        n = int(self.traffic["streams"])
        streams = [traffic_gen.stream(self.traffic, self.seed, i)
                   for i in range(n)]
        if tracer is not None:
            tracer.wrap(planner, "lower", "planner.lower (plan-cache miss)")
            tracer.wrap(self.service, "_serve_round", "service round")
            tracer.record_launches()
            tracer.start()
        cache0 = planner.plan_cache_info()
        t_open = time.perf_counter()
        t_close = t_open + seconds
        self.window = w = Window(t_open, t_close)

        def client(i):
            done = []
            for name, params in streams[i]:
                if time.perf_counter() >= t_close:
                    break
                done.append(self.request(name, params))
            return done
        for reqs in self._clients(client, n, timeout=seconds + 300):
            w.requests.extend(reqs)
        cache1 = planner.plan_cache_info()
        self.report_pools("after the window")
        records = {}
        if tracer is not None:
            tracer.stop()
            records = tracer.records(t_open, t_close)
        answered = [r for r in w.requests if r.value is not None]
        inside = [r for r in answered if r.t1 <= t_close]
        lat_ms = [(r.t1 - r.t0) * 1e3 for r in answered]
        e2e = {"queries_per_s": stats.rate(len(inside), seconds)}
        if lat_ms:
            e2e["query_p95_ms"] = stats.percentile(lat_ms, 95)
        records.update({
            "completed": len(inside),
            "requests": [{"latency_s": r.service_latency_s,
                          "phases": r.phases} for r in answered],
            "plan_cache": {"before": cache0._asdict(),
                           "after": cache1._asdict()}})
        failed = [r for r in w.requests if r.error is not None]
        for r in failed[:5]:
            print(f"tpch: request {r.key} failed: {r.error}",
                  file=sys.stderr)
        print(f"tpch: {len(inside)} queries completed in the window, "
              f"{len(w.requests)} submitted; median "
              f"{stats.percentile(lat_ms, 50) if lat_ms else 'n/a'} ms",
              file=sys.stderr)
        return {"attempted": len(w.requests), "failed": len(failed),
                "end_to_end": e2e, "records": records}

    # -- after the window -----------------------------------------------------
    def release(self) -> None:
        """Free the program's state: the service, its pools and caches."""
        from repro_torch.analytics import planner
        if self.service is not None:
            self.service.stop()
            self.service.close()
            self.service = None
        planner.clear_plan_cache()
        planner.join_index_pool().clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def answered(self) -> Dict[queries.Key, List[Request]]:
        """Every answered request of the window, by (query, parameters)."""
        by_key: Dict[queries.Key, List[Request]] = {}
        for r in self.window.requests:
            if r.value is not None:
                by_key.setdefault(r.key, []).append(r)
        return dict(sorted(by_key.items()))

    def check(self, control: Optional[torch.dtype] = None) -> dict:
        """{"gaps": {query: widest rel_gap}, "mismatches", "answers"} of
        every answer of the window against the float64 reference, worked
        out once for each distinct (query, parameters); with ``control``,
        of the reference computed in that dtype put in the program's
        place."""
        t0 = time.perf_counter()
        chosen = self.answered()
        ref = Reference(self.tables)
        low = Reference(self.tables, control) if control is not None \
            else None
        gaps: Dict[str, float] = {}
        took: Dict[str, float] = {}
        bad, answers = 0, 0
        for key, reqs in chosen.items():
            name, params = key[0], queries.params_of(key)
            t = time.perf_counter()
            want = ref.answer(name, params)
            gots = [low.answer(name, params)] if low is not None else \
                [r.value for r in reqs]
            took[name] = took.get(name, 0.0) + time.perf_counter() - t
            judged: List[tuple] = []
            for got in gots:
                seen = [v for a, v in judged if compare.same(got, a)]
                g, b = seen[0] if seen else compare.judge(got, want)
                if not seen:
                    judged.append((got, (g, b)))
                gaps[name] = max(gaps.get(name, 0.0), g)
                bad, answers = bad + b, answers + 1
                if b:
                    print(f"tpch: {key}: {b} mismatches", file=sys.stderr)
        print(f"tpch: judged {answers} answers of {len(chosen)} keys in "
              f"{time.perf_counter() - t0:.2f} s; reference s by query: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(took.items())),
              file=sys.stderr)
        return {"gaps": gaps, "mismatches": bad, "answers": answers}
