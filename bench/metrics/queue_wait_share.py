"""Share of served latency spent waiting in the service before execution:
the admission queue and the batcher's round, summed over every query
completed in the window, over the sum of their latencies (the service's
own disjoint phases of each QueryResult)."""
NAME = "queue_wait_share"
LAYER = "service (analytics/service/: AdmissionQueue, QueryBatcher, the serve loop)"
UNIT = "%"
MOVES = "query_p95_ms"
SOURCE = "program_span"


def read(records):
    reqs = [r for r in records.get("requests", []) if r.get("phases")]
    total = sum(r["latency_s"] for r in reqs)
    if not reqs or total <= 0:
        return None
    waited = sum(r["phases"]["queue_wait"] + r["phases"]["batch_wait"]
                 for r in reqs)
    return 100.0 * waited / total
