"""Device-arena memory management: allocators, paged KV cache, microbench."""
from repro_torch.memory.allocators import (Allocator, AllocStats, Block,
                                           make_allocator)
from repro_torch.memory.microbench import (MicrobenchResult, run_microbench,
                                           sweep)
from repro_torch.memory.paged_kv import PagedKVManager, gather_sequence
