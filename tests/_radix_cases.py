"""Edge cases of the radix index probe, as numpy arrays.

Each case is (build keys int32, build values float32, probe keys int32)
for ``build_radix_index`` at its default ``bits`` (1,024 buckets) and a
probe of the index it builds. Shared by the CUDA kernel's tests
(``test_torch_cuda.py``, no jax) and the plain version's tests against
the reference (``test_torch_kernel_orders.py``). ``scale`` multiplies the
Blanas draws' sizes: 100 gives the card's 200K x 3.2M.
"""
import numpy as np

from repro_torch.analytics.datasets import blanas_join

BITS = 10
_KNUTH = 2654435761
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def bucket_of(keys, bits=BITS):
    """The multiply-shift bucket of each int32 key (``hashing``'s)."""
    h = (keys.astype(np.uint32).astype(np.uint64) * np.uint64(_KNUTH)
         ) & np.uint64(0xFFFFFFFF)
    return (h >> np.uint64(32 - bits)).astype(np.int64)


def keys_in_bucket(rng, bucket, n, bits=BITS):
    """n distinct int32 keys whose multiply-shift bucket is ``bucket``,
    sorted: the inverse of the hash's multiply on hashes with those top
    bits."""
    low = rng.choice(1 << (32 - bits), n, replace=False).astype(np.uint64)
    h = (np.uint64(bucket) << np.uint64(32 - bits)) | low
    keys = (h * np.uint64(pow(_KNUTH, -1, 1 << 32))) & np.uint64(0xFFFFFFFF)
    return np.sort(keys.astype(np.uint32).view(np.int32))


def _vals(rng, n):
    return rng.rand(n).astype(np.float32)


def blanas(rng, scale=1):
    jd = blanas_join(2_000 * scale, 32_000 * scale,
                     seed=int(rng.randint(1 << 30)))
    return jd.build_keys, jd.build_vals, jd.probe_keys


def blanas_with_misses(rng, scale=1):
    bk, bv, pk = blanas(rng, scale)
    pk = pk.copy()
    pk[::5] = 4 * len(bk) + 7               # above every build key
    pk[1::7] = -1
    pk[2::11] = rng.randint(0, 4 * len(bk), len(pk[2::11]))  # some miss
    return bk, bv, pk


def empty_buckets(rng, scale=1):
    """300 build keys in 1,024 buckets: most runs are empty."""
    bk = rng.choice(4_000, 300, replace=False).astype(np.int32)
    pk = np.concatenate([bk, rng.randint(0, 4_000, 3_000).astype(np.int32)])
    return bk, _vals(rng, 300), rng.permutation(pk)


def past_the_run(rng, scale=1):
    """Probes above every key of their bucket's run: in the last bucket
    (whose run ends at n, the plain route's n - 1 clamp) and in a middle
    one (whose run ends at the next bucket's first key)."""
    last = keys_in_bucket(rng, (1 << BITS) - 1, 60)
    mid = keys_in_bucket(rng, 500, 60)
    other = rng.choice(1 << 20, 2_000, replace=False).astype(np.int32)
    other = other[~np.isin(bucket_of(other), [500, (1 << BITS) - 1])]
    bk = np.concatenate([last[:50], mid[:50], other])
    bk = bk[rng.permutation(len(bk))]
    pk = np.concatenate([last[50:], mid[50:], last[:50], mid[:50],
                         np.full(5, last.max(), np.int32)])
    return bk, _vals(rng, len(bk)), rng.permutation(pk)


def extreme_keys(rng, scale=1):
    """Probe keys -1, -2, INT32_MIN and INT32_MAX; the build holds -1 and
    INT32_MIN, not -2 or INT32_MAX."""
    bk = np.concatenate([[-1, INT32_MIN], rng.randint(
        INT32_MIN + 1, INT32_MAX, 3_000)]).astype(np.int32)
    bk = np.unique(bk[bk != -2])
    bk = bk[rng.permutation(len(bk))]
    pk = np.concatenate([np.repeat(np.array(
        [-1, -2, INT32_MIN, INT32_MAX], np.int32), 50), bk[:500]])
    return bk, _vals(rng, len(bk)), rng.permutation(pk)


def one_build_key(rng, scale=1):
    pk = np.array([7, 6, 8, -1, 7, INT32_MAX, INT32_MIN, 7], np.int32)
    return np.array([7], np.int32), np.array([3.5], np.float32), pk


def no_probe_keys(rng, scale=1):
    bk, bv, _ = blanas(rng, scale)
    return bk, bv, np.zeros(0, np.int32)


def duplicate_build_keys(rng, scale=1):
    """Build keys drawn with replacement, each value its slot (and -0.0
    at every seventh): the first occurrence's value wins."""
    bk = rng.randint(0, 1_500, 4_000).astype(np.int32)
    bv = np.arange(4_000, dtype=np.float32)
    bv[::7] = -0.0
    pk = rng.randint(0, 2_000, 8_000).astype(np.int32)
    return bk, bv, pk


CASES = {
    "blanas": blanas,
    "blanas with misses": blanas_with_misses,
    "empty buckets": empty_buckets,
    "past the run": past_the_run,
    "keys -1, -2 and +-2^31": extreme_keys,
    "one build key": one_build_key,
    "no probe keys": no_probe_keys,
    "duplicate build keys": duplicate_build_keys,
}


def case(name, seed=0, scale=1):
    return CASES[name](np.random.RandomState(seed), scale)
