"""Edge cases of the partition-wise join probe, as numpy arrays.

Shared by the CUDA kernel's tests (``test_torch_cuda.py``, no jax) and the
plain version's tests against the reference (``test_torch_kernel_orders.py``).
Every payload is an integer-valued float32 (or -0.0), so a sum of padding
values is exact in any order. Build keys other than -1 are unique within a
partition (PK-FK), as the kernel requires.
"""
import numpy as np
import torch

from repro_torch.kernels.join_probe.ops import table_log2, unmix32

SF1_BK = 46_976            # q3's build width per partition at SF1


def _payload(rng, shape):
    return rng.randint(0, 1 << 20, shape).astype(np.float32)


def _unique_keys(rng, n, lo, hi):
    """n distinct int32 keys in [lo, hi), none of them -1."""
    keys = rng.choice(np.arange(lo, hi, dtype=np.int64), n, replace=False)
    keys[keys == -1] = hi
    return keys.astype(np.int32)


def colliding_keys(n, Bk):
    """n distinct keys whose walks all start at one entry of a table for
    Bk build slots: their mixed hashes share the top bits."""
    b = table_log2(Bk)
    hashes = (5 << (32 - b)) + torch.arange(n + 1, dtype=torch.int64)
    keys = unmix32(hashes).numpy().astype(np.uint32).view(np.int32)
    return keys[keys != -1][:n]


def sf1_partition(rng, pk=60_000):
    """One partition as wide as q3's at SF1: a fifth of it padding, probes
    that hit, miss and pad."""
    Bk = SF1_BK
    bk = _unique_keys(rng, Bk, 0, 3 * Bk)[None]
    bv = np.arange(Bk, dtype=np.float32)[None].copy()
    bk[:, Bk - Bk // 5:] = -1
    bv[bk < 0] = 0.0
    pkeys = rng.randint(0, 3 * Bk, (1, pk)).astype(np.int32)
    pkeys[:, ::7] = -1
    return bk, bv, pkeys


def no_padding_probed_with_padding(rng, pk=2_000):
    P, Bk = 3, 500
    bk = np.stack([_unique_keys(rng, Bk, 0, 4 * Bk) for _ in range(P)])
    pkeys = rng.randint(-1, 4 * Bk, (P, pk)).astype(np.int32)
    pkeys[:, ::3] = -1
    return bk, _payload(rng, (P, Bk)), pkeys


def all_padding_partition(rng, pk=2_000):
    """Partition 1 is all padding, partition 0 part padding, partition 2
    none; the padding carries nonzero integer payloads to be summed."""
    P, Bk = 3, 777
    bk = np.stack([_unique_keys(rng, Bk, 0, 4 * Bk) for _ in range(P)])
    bk[0, ::5] = -1
    bk[1] = -1
    bv = rng.randint(-50, 50, (P, Bk)).astype(np.float32)
    pkeys = rng.randint(-1, 4 * Bk, (P, pk)).astype(np.int32)
    pkeys[:, ::4] = -1
    return bk, bv, pkeys


def extreme_keys(rng, pk=3_000):
    """Keys within 1000 of -2^31 and of 2^31 - 1, and around -1."""
    P, Bk = 2, 900
    pool = np.concatenate([np.arange(-(1 << 31), -(1 << 31) + 1000),
                           np.arange((1 << 31) - 1000, 1 << 31),
                           np.arange(-500, 500)])
    pool = pool[pool != -1]
    bk = np.stack([rng.choice(pool, Bk, replace=False)
                   for _ in range(P)]).astype(np.int32)
    bk[:, -50:] = -1
    bv = _payload(rng, (P, Bk))
    pkeys = np.concatenate([rng.choice(pool, (P, pk - 100)),
                            np.full((P, 100), -1)], axis=1).astype(np.int32)
    return bk, bv, pkeys


def colliding(rng, pk=3_000):
    """Every key of the build side and most probes start their walk at one
    table entry; half the probes of those miss and walk the whole chain."""
    Bk = 1_500
    keys = colliding_keys(2 * Bk, Bk)
    bk = keys[:Bk][None].copy()
    bk[:, -10:] = -1
    pkeys = rng.choice(keys, (1, pk)).astype(np.int32)
    pkeys[:, ::11] = -1
    return bk, _payload(rng, (1, Bk)), pkeys


def capacity_multiples(rng, pk=3_000):
    """Keys that are multiples of the table's capacity (they would all
    collide under a modulo hash)."""
    P, Bk = 2, 1_000
    cap = 1 << table_log2(Bk)
    bk = np.stack([rng.permutation(2 * Bk)[:Bk] * cap
                   for _ in range(P)]).astype(np.int32)
    pkeys = (rng.randint(0, 2 * Bk, (P, pk)) * cap).astype(np.int32)
    return bk, _payload(rng, (P, Bk)), pkeys


def negative_zero_payload(rng, pk=2_000):
    """Payloads of -0.0 (and of +0.0, and negative ones) that hit."""
    P, Bk = 2, 600
    bk = np.stack([_unique_keys(rng, Bk, 0, 2 * Bk) for _ in range(P)])
    bv = _payload(rng, (P, Bk)) - (1 << 19)
    bv[:, ::3] = -0.0
    bv[:, 1::3] = 0.0
    bk[:, -20:] = -1
    bv[:, -20:] = -0.0
    pkeys = rng.randint(-1, 2 * Bk, (P, pk)).astype(np.int32)
    return bk, bv, pkeys


CASES = {
    "sf1 partition": sf1_partition,
    "no padding, probed with -1": no_padding_probed_with_padding,
    "all-padding partition": all_padding_partition,
    "keys near +-2^31": extreme_keys,
    "keys in one hash chain": colliding,
    "keys multiples of the capacity": capacity_multiples,
    "-0.0 payload": negative_zero_payload,
}


def case(name, seed=0, **kw):
    return CASES[name](np.random.RandomState(seed), **kw)
