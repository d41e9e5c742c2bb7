"""Share of its roofline that the join_probe kernel reached: the
least time of every launch's shapes (bench/roofline.py) over the device
time of its kernels (join_build_kernel and join_probe_kernel) under
torch.profiler."""
from bench.devtrace import roofline_share

NAME = "join_probe_roofline"
LAYER = "kernels (csrc/hash_aggregate.cu, csrc/join_probe.cu)"
UNIT = "%"
MOVES = "rows_per_s"
SOURCE = "device_trace"


def read(records):
    return roofline_share(records, "join_probe")
