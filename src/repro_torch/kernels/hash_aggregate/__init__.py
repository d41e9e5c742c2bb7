from repro_torch.kernels.hash_aggregate.ops import (hash_aggregate,
                                                    hash_aggregate_multi)
