"""Device milliseconds a query: the union of the device's kernel, copy
and memset intervals in the window (torch.profiler) over the queries
completed in it."""
NAME = "device_ms_per_query"
LAYER = "operators (columnar.py under planner._LocalExecutor)"
UNIT = "ms"
MOVES = "queries_per_s"
SOURCE = "device_trace"


def read(records):
    n = records.get("completed", 0)
    if not n or records.get("busy_s", 0) <= 0:
        return None
    return 1e3 * records["busy_s"] / n
