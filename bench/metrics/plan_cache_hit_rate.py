"""Hits of the planner's LRU plan cache over its look-ups during the
window (the change in ``planner.plan_cache_info()``)."""
NAME = "plan_cache_hit_rate"
LAYER = "planning (planner.compile_plan, the LRU plan cache of 64)"
UNIT = "%"
MOVES = "query_p95_ms"
SOURCE = "program_counter"


def read(records):
    pc = records.get("plan_cache")
    if not pc:
        return None
    hits = pc["after"]["hits"] - pc["before"]["hits"]
    misses = pc["after"]["misses"] - pc["before"]["misses"]
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
