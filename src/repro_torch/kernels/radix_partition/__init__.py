from repro_torch.kernels.radix_partition.ops import (block_histograms,
                                                     padded_bin_counts,
                                                     radix_partition)
