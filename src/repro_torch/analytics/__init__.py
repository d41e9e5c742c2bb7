"""In-memory analytics engine on PyTorch: the paper's five workloads.

W1 holistic aggregation (median)      aggregate.median_direct / dist_median
W2 distributive aggregation (count)   aggregate.count_* / dist_count
W3 hash join                          join.hash_join / dist_hash_join
W4 index nested-loop join             join.index_join (radix/sorted/hash)
W5 TPC-H                              tpch.run_query (q1 q3 q5 q6 q18 qm qq)

Queries are logical plans (plan.py), lowered by the cost-based planner
(planner.lower) into an explicit physical plan (physical.py) and walked
over the columnar operators (columnar.py) and CUDA kernels, on one
device or on a virtual mesh of shards under a placement policy
(engine.py, core/vmesh.py). Telemetry (telemetry.py) records observed
rows per node and feeds them back into the cost model; tracing
(tracing.py) records spans on the host. Concurrent multi-query serving
(admission queue -> batcher -> morsel scheduler over worker pools, each
on a CUDA stream of its own) lives in the service/ subpackage.
"""
from repro_torch.analytics import datasets, physical, plan
from repro_torch.analytics.aggregate import (count_direct, count_partitioned,
                                             median_direct, median_jit)
from repro_torch.analytics.engine import (dist_count, dist_hash_join,
                                          dist_median)
from repro_torch.analytics.join import hash_join, index_join
from repro_torch.analytics.planner import (CompiledPlan, ExecutionContext,
                                           compile_plan, execute_plan,
                                           explain, explain_analyze,
                                           explain_physical,
                                           load_cost_profile, lower,
                                           plan_cache_info)
from repro_torch.analytics.telemetry import (StatsRegistry,
                                             disable_telemetry,
                                             enable_telemetry,
                                             refresh_profile,
                                             telemetry_enabled)
from repro_torch.analytics.telemetry import recording as telemetry_recording
from repro_torch.analytics.telemetry import registry as telemetry_registry
from repro_torch.analytics.tracing import (FlightRecorder, Span, Trace,
                                           Tracer, disable_tracing,
                                           enable_tracing, tracer,
                                           tracing_enabled)
# the context manager is aliased so the package attribute ``tracing`` stays
# the submodule (as telemetry_recording does for ``recording``)
from repro_torch.analytics.tracing import tracing as tracing_scope
from repro_torch.analytics.tpch import LOGICAL_QUERIES
from repro_torch.analytics.tpch import generate as tpch_generate
from repro_torch.analytics.tpch import run_query as tpch_run_query
