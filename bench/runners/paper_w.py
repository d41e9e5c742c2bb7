"""The paper's W1-W4 as batch jobs on one device, back to back.

The mix names the jobs, run in turn from one thread: a job is complete
when its result is on the host. Inputs are drawn once from the seed (the
aggregation inputs for W1/W2 jobs, the join tables for W3/W4 jobs) and
every job reads them. A W1 or W2 job counts its records as rows; a W3
or W4 job counts build plus probe rows. Every job's answer is judged
against the plain reference, which is worked out once per kind of job.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import compare, stats
from bench.datagen.paper_w import make_inputs
from bench.reference import paper_w as reference


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _jobs(sizes: dict) -> Dict[str, Tuple[str, str, Callable]]:
    """{job name: (input set, reference kind, run(inputs) -> host answer)}."""
    from repro_torch.analytics import aggregate, join
    groups = int(sizes["agg"]["groups"])
    parts = dict(n_partitions=int(sizes["n_partitions"]),
                 capacity_factor=float(sizes["capacity_factor"]))

    def w1(x):
        return {"medians": _host(aggregate.median_direct(
            x["keys"], x["vals"], groups))}

    def w2(x):
        c, ovf = aggregate.count_partitioned(x["keys"], groups, **parts)
        return {"counts": _host(c), "overflow": _host(ovf)}

    def w3(x):
        n, s, ovf = join.hash_join(x["build_keys"], x["build_vals"],
                                   x["probe_keys"], **parts)
        return {"count": _host(n), "checksum": _host(s),
                "overflow": _host(ovf)}

    def w4(kind):
        def run(x):
            n, s = join.index_join(x["build_keys"], x["build_vals"],
                                   x["probe_keys"], kind)
            return {"count": _host(n), "checksum": _host(s)}
        return run

    jobs = {"w1.median_direct": ("agg", "median", w1),
            "w2.count_partitioned": ("agg", "count", w2),
            "w3.hash_join": ("join", "join", w3)}
    for kind in ("radix", "sorted"):
        jobs[f"w4.index_join.{kind}"] = ("join", "join", w4(kind))
    return jobs


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.results: List[Tuple[str, Dict[str, np.ndarray]]] = []

    def rows(self, job: str) -> int:
        s = self.config["sizes"]
        if self.jobs[job][0] == "agg":
            return int(s["agg"]["records"])
        return int(s["join"]["build"]) + int(s["join"]["probe"])

    def setup(self) -> None:
        self.jobs = _jobs(self.config["sizes"])
        self.order = list(self.traffic["jobs"])
        unknown = [j for j in self.order if j not in self.jobs]
        if unknown:
            raise ValueError(f"unknown jobs {unknown}; have {list(self.jobs)}")
        needs = {self.jobs[j][0] for j in self.order}
        self.inputs = make_inputs(self.config["sizes"], needs,
                                  self.traffic.get("keys", {}), self.seed,
                                  self.device)
        for _ in range(int(self.traffic.get("warmup_passes", 1))):
            for j in self.order:
                self.jobs[j][2](self.inputs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, seconds: float, tracer=None) -> dict:
        if tracer is not None:
            tracer.record_launches()
            tracer.start()
        t_open = time.perf_counter()
        t_close = t_open + seconds
        done: List[Tuple[str, float]] = []
        i = 0
        while time.perf_counter() < t_close:
            job = self.order[i % len(self.order)]
            i += 1
            if tracer is not None:
                with tracer.span(job):
                    out = self.jobs[job][2](self.inputs)
            else:
                out = self.jobs[job][2](self.inputs)
            done.append((job, time.perf_counter()))
            self.results.append((job, out))
        records = {}
        if tracer is not None:
            tracer.stop()
            records = tracer.records(t_open, t_close)
        rows = sum(self.rows(j) for j, t in done if t <= t_close)
        inside = sum(1 for _, t in done if t <= t_close)
        print(f"paper_w: {inside} jobs completed in the window "
              f"({len(done)} run)", file=sys.stderr)
        records["completed"] = inside
        return {"attempted": len(done), "failed": 0,
                "end_to_end": {"rows_per_s": stats.rate(rows, seconds)},
                "records": records}

    def release(self) -> None:
        """The program keeps no state between jobs but the allocator's."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self, control: Optional[torch.dtype] = None) -> dict:
        """{"gaps": {kind of job: widest rel_gap}, "mismatches",
        "answers"} of every job's answer against the float64 reference;
        with ``control``, of the reference computed in that dtype put in
        the program's place."""
        t0 = time.perf_counter()
        groups = int(self.config["sizes"]["agg"]["groups"])
        wants: Dict[str, dict] = {}
        gaps: Dict[str, float] = {}
        bad, answers = 0, 0

        judged: Dict[str, tuple] = {}

        def judge(job, got):
            """An answer equal to the one judged first for its job says
            the same thing and keeps its verdict."""
            nonlocal bad, answers
            kind = self.jobs[job][1]
            seen = judged.get(job)
            if seen is not None and compare.same(got, seen[0]):
                g, b = seen[1]
            else:
                g, b = compare.judge(got, wants[job])
                judged.setdefault(job, (got, (g, b)))
            gaps[kind] = max(gaps.get(kind, 0.0), g)
            bad, answers = bad + b, answers + 1
            if b:
                print(f"paper_w: {job}: {b} mismatches", file=sys.stderr)
        for job in dict.fromkeys(j for j, _ in self.results):
            kind = self.jobs[job][1]
            want = dict(reference.answer(kind, self.inputs, groups))
            if job == "w3.hash_join":
                want["overflow"] = np.array(0, dtype=np.int32)
            wants[job] = want
            if control is not None:
                got = dict(reference.answer(kind, self.inputs, groups,
                                            control))
                got.update({k: want[k] for k in want if k not in got})
                judge(job, got)
        if control is None:
            for job, got in self.results:
                judge(job, got)
        print(f"paper_w: judged {answers} answers in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
        return {"gaps": gaps, "mismatches": bad, "answers": answers}
