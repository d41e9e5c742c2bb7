"""Share of the window in which the device ran nothing: 1 - the union of
its kernel, copy and memset intervals (torch.profiler) over the window;
in the served cells."""
NAME = "idle_share.serve"
LAYER = "device"
UNIT = "%"
MOVES = "queries_per_s"
SOURCE = "device_trace"


def read(records):
    w = records.get("window_s", 0)
    if w <= 0 or records.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - records["busy_s"] / w)
