"""The virtual mesh's collectives (repro_torch.core.vmesh) against numpy
definitions of the jax.lax collectives, and its failure handling: an
error in one shard, a shard that skips a collective, and a shard that
never arrives all reach the caller within a bounded time."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.vmesh import MeshError, VirtualMesh, shard_rows

N = 4


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 100).astype(dtype) for _ in range(N)]


def _run(fn, xs, n=N, timeout=30.0):
    mesh = VirtualMesh(n, "cpu", timeout=timeout)
    return mesh.run(lambda comm, x: fn(comm, x),
                    [torch.from_numpy(x) for x in xs])


def test_all_to_all_tiled_sends_row_block_j_to_shard_j():
    xs = _inputs(0, (N * 3, 2))
    got = _run(lambda c, x: c.all_to_all(x), xs)
    for j in range(N):
        want = np.concatenate([x[3 * j:3 * j + 3] for x in xs])
        np.testing.assert_array_equal(got[j].numpy(), want)


def test_psum_scatter_tiled_keeps_row_block_i_of_the_sum():
    xs = _inputs(1, (N * 5,))
    got = _run(lambda c, x: c.psum_scatter(x), xs)
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x                  # rank order, in float32
    for i in range(N):
        np.testing.assert_array_equal(got[i].numpy(),
                                      total[5 * i:5 * i + 5])


def test_all_gather_tiled_concatenates_in_rank_order():
    xs = _inputs(2, (3, 2))
    got = _run(lambda c, x: c.all_gather(x), xs)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), np.concatenate(xs))


def test_psum_adds_in_rank_order_and_is_replicated():
    xs = _inputs(3, (1000,))
    got = _run(lambda c, x: (c.psum(x), c.pmax(x), c.pmin(x),
                             c.axis_index()), xs)
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    for rank, (s, mx, mn, idx) in enumerate(got):
        assert idx == rank
        np.testing.assert_array_equal(s.numpy(), total)      # bit for bit
        np.testing.assert_array_equal(mx.numpy(), np.max(xs, axis=0))
        np.testing.assert_array_equal(mn.numpy(), np.min(xs, axis=0))


def test_int32_collectives_keep_int32():
    xs = [np.full((N * 2,), r, np.int32) for r in range(N)]
    got = _run(lambda c, x: (c.psum(x), c.all_to_all(x),
                             c.psum_scatter(x)), xs)
    assert all(t.dtype == torch.int32 for out in got for t in out)


def test_an_error_in_one_shard_reaches_the_caller():
    def fn(comm, x):
        if comm.rank == 2:
            raise KeyError("shard two failed")
        return comm.psum(x)

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard two"):
        _run(fn, _inputs(4, (3,)), timeout=30.0)
    assert time.monotonic() - t0 < 10.0      # the barrier was aborted


def test_a_shard_that_skips_a_collective_fails_the_run():
    def fn(comm, x):
        return x if comm.rank == 1 else comm.psum(x)

    with pytest.raises(MeshError, match="disagree"):
        _run(fn, _inputs(5, (3,)))


def test_a_shard_that_never_arrives_times_out():
    release = threading.Event()

    def fn(comm, x):
        if comm.rank == 0:
            release.wait(1.5)
        return comm.psum(x)

    t0 = time.monotonic()
    with pytest.raises(MeshError):
        _run(fn, _inputs(6, (3,)), timeout=0.5)
    release.set()
    assert time.monotonic() - t0 < 10.0


def test_one_shard_runs_at_a_time_between_collectives():
    lock = threading.Lock()
    state = {"active": 0, "most": 0}

    def busy():
        with lock:
            state["active"] += 1
            state["most"] = max(state["most"], state["active"])
        time.sleep(0.01)              # a shard that computes for a while
        with lock:
            state["active"] -= 1

    def fn(comm, x):
        busy()
        x = comm.psum(x)
        busy()
        return x

    _run(fn, _inputs(7, (3,)))
    assert state["most"] == 1


def test_shard_rows_splits_contiguous_blocks():
    a = torch.arange(12)
    parts = shard_rows({"t": {"a": a}}, 4)
    assert [p["t"]["a"].tolist() for p in parts] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    with pytest.raises(ValueError, match="split"):
        shard_rows({"t": {"a": torch.arange(5)}}, 4)


def test_collectives_stay_exact_under_thread_switching_stress():
    """More shards than cores and a short switch interval: a lost or
    misrouted post would break the exact integer sums."""
    n = 16
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(comm, x):
            acc = x
            for _ in range(30):
                acc = comm.psum(acc) % 1000003
                acc = comm.all_to_all(acc)
            return acc

        xs = [np.arange(n, dtype=np.int64) * (r + 1) for r in range(n)]
        got = _run(fn, xs, n=n)
    finally:
        sys.setswitchinterval(prev)
    want = [x.copy() for x in xs]
    for _ in range(30):
        s = sum(want[1:], want[0].copy()) % 1000003
        want = [np.concatenate([s[j:j + 1] for _ in range(n)])
                for j in range(n)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
