"""Share of its roofline that the hash_aggregate kernel reached: the
least time of every launch's shapes (bench/roofline.py) over the device
time of its kernels (agg_partial_kernel and agg_reduce_kernel) under
torch.profiler."""
from bench.devtrace import roofline_share

NAME = "hash_aggregate_roofline"
LAYER = "kernels (csrc/hash_aggregate.cu, csrc/join_probe.cu)"
UNIT = "%"
MOVES = "rows_per_s"
SOURCE = "device_trace"


def read(records):
    return roofline_share(records, "hash_aggregate_multi")
