#!/usr/bin/env python
"""Gate for the port's telemetry -> cost-model feedback loop: the
scenario of ``scripts/drift_gate.py`` on ``repro_torch``, on a virtual
mesh of 4 shards. Exits non-zero if any link of the loop is broken:

  1. a deliberately MIS-PRICED CostProfile (dist_route_factor 2x too
     high) makes the static cost model pick a broadcast join for a
     selective-probe query where partitioned is right;
  2. ONE telemetry-recorded execution produces a non-empty drift report
     (the probe filter keeps ~10% of rows, invisible to static costing);
  3. the next plan-cache HIT re-lowers with the observed alive rows and
     flips the decision to partitioned, with results bit-identical to a
     fault-free run;
  4. ``refresh_profile()`` pulls the mispriced constant back: lowering
     afresh with the refreshed profile picks partitioned statically.

Runs on the card by default (and raises when there is none), or on the
CPU with ``--device cpu``:

    PYTHONPATH=src python scripts/drift_gate_torch.py [--device cpu]
"""
import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analytics import physical as PH  # noqa: E402
from repro_torch.analytics import plan as L  # noqa: E402
from repro_torch.analytics import planner, telemetry  # noqa: E402
from repro_torch.core.config import (PlacementPolicy,  # noqa: E402
                                     resolve_device)

N_SHARDS = 4


def same_bits(a, b) -> bool:
    return set(a) == set(b) and all(
        torch.equal(torch.nan_to_num(a[k], nan=-7.0),
                    torch.nan_to_num(b[k], nan=-7.0)) for k in a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the tables lie: cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.RandomState(7)
    n_rows, dim_rows = 768, 576
    raw = {"fact": {"fk": rng.randint(0, dim_rows, n_rows).astype(np.int32),
                    "fv": rng.rand(n_rows).astype(np.float32)},
           "dim": {"pk": np.arange(dim_rows, dtype=np.int32),
                   "dv": rng.rand(dim_rows).astype(np.float32)}}
    tables = {t: {c: torch.from_numpy(a).to(dev) for c, a in cols.items()}
              for t, cols in raw.items()}
    j = (L.scan("fact").filter(L.col("fv") < 0.1)
         .join(L.scan("dim"), "fk", "pk", {"dv": "dv"}))
    p = L.LogicalPlan(j.aggregate("fk", dim_rows, c=("count", "fv"),
                                  m=("median", "dv"), x=("max", "fv")),
                      ("c", "m", "x"))
    ctx = planner.ExecutionContext(executor="cost", n_shards=N_SHARDS,
                                   policy=PlacementPolicy.INTERLEAVE)

    planner.set_cost_profile(None)
    ref = planner.compile_plan(p, tables, ctx)(tables)

    mispriced = planner.CostProfile(dist_route_factor=3.0)
    planner.set_cost_profile(mispriced)
    telemetry.registry().clear()
    try:
        with telemetry.recording() as reg:
            cp1 = planner.compile_plan(p, tables, ctx)
            if "dist=broadcast" not in PH.describe(cp1.physical):
                print("drift_gate_torch: FAIL: the mispriced profile did "
                      "not pick broadcast:\n" + PH.describe(cp1.physical))
                return 1
            out1 = cp1(tables)
            report = reg.drift_report()
            if not report:
                print("drift_gate_torch: FAIL: one recorded execution gave "
                      "an EMPTY drift report")
                return 1
            print(f"drift_gate_torch: drift report of {len(report)} "
                  f"entries; worst: {report[0]['node']} {report[0]['stat']} "
                  f"obs={report[0]['observed']} "
                  f"est={report[0]['estimated']}")
            cp2 = planner.compile_plan(p, tables, ctx)   # cache HIT
            if "dist=partitioned" not in PH.describe(cp2.physical):
                print("drift_gate_torch: FAIL: the cache-hit replan did not "
                      "flip to partitioned:\n" + PH.describe(cp2.physical))
                return 1
            out2 = cp2(tables)
        if not (same_bits(out1, ref) and same_bits(out2, ref)):
            print("drift_gate_torch: FAIL: a drifting or replanned result "
                  "differs from the fault-free run")
            return 1
        print(f"drift_gate_torch: replan flipped broadcast -> partitioned "
              f"on a cache hit (replans={reg.summary()['replans']}), "
              "results bit-identical to the fault-free run")

        refreshed = telemetry.refresh_profile(mispriced)
        rows = {t: next(iter(c.values())).shape[0]
                for t, c in tables.items()}
        fresh = planner.lower(p, ctx, rows, profile=refreshed)
        if (refreshed.dist_route_factor >= mispriced.dist_route_factor
                or "dist=partitioned" not in PH.describe(fresh)):
            print(f"drift_gate_torch: FAIL: refresh_profile did not correct "
                  f"the mispriced constant (factor "
                  f"{mispriced.dist_route_factor} -> "
                  f"{refreshed.dist_route_factor})")
            return 1
    finally:
        planner.set_cost_profile(None)
        telemetry.registry().clear()
    print(f"drift_gate_torch: profile corrected within one execution "
          f"(dist_route_factor {mispriced.dist_route_factor} -> "
          f"{refreshed.dist_route_factor}, source={refreshed.source!r}) "
          f"on {dev}")
    print("drift_gate_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
