"""Device-arena memory management: allocators and the paged KV cache."""
from repro_torch.memory.allocators import (Allocator, AllocStats, Block,
                                           make_allocator)
from repro_torch.memory.paged_kv import PagedKVManager, gather_sequence
