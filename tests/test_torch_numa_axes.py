"""The paper's allocator, OS and placement axes in the port, against the
reference: the allocator microbenchmark, ``MeshLayout`` and ``OSConfig``,
the torus geometry and its cost functions (given the reference's rates),
the mesh layouts; and the host NUMA topology read from sysfs trees."""
import dataclasses
import os
import re

import numpy as np
import pytest

from repro.core import config as RC
from repro.core import meshes as RMesh
from repro.core import topology as RT
from repro.memory import microbench as RB
from repro_torch.core import config as TC
from repro_torch.core import meshes as TMesh
from repro_torch.core import topology as TT
from repro_torch.memory import microbench as TB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORI = [(1, 16, 16), (2, 16, 16), (1, 4, 8)]
TIMES = ("seconds", "ops_per_sec")


def _fields(result):
    d = dataclasses.asdict(result)
    return {k: v for k, v in d.items() if k not in TIMES}


@pytest.mark.parametrize("n_streams", [1, 8])
@pytest.mark.parametrize("kind", [k.value for k in TC.AllocatorKind])
def test_run_microbench_matches_reference(kind, n_streams):
    got = TB.run_microbench(TC.AllocatorKind(kind), n_streams=n_streams,
                            ops_per_stream=400)
    want = RB.run_microbench(RC.AllocatorKind(kind), n_streams=n_streams,
                             ops_per_stream=400)
    assert _fields(got) == _fields(want)
    assert got.seconds > 0 and got.ops_per_sec > 0


def test_sweep_matches_reference():
    got = TB.sweep(n_streams_list=(1, 4), ops_per_stream=200)
    want = RB.sweep(n_streams_list=(1, 4), ops_per_stream=200)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [(r.kind, r.n_streams) for r in got] == [
        (k.value, n) for k in TC.AllocatorKind for n in (1, 4)]


def test_size_sampler_draws_the_references_sizes():
    got = TB._size_sampler(np.random.RandomState(3), 5000)
    want = RB._size_sampler(np.random.RandomState(3), 5000)
    np.testing.assert_array_equal(got, want)


def test_memory_package_exports_the_microbenchmark():
    from repro_torch import memory
    assert memory.run_microbench is TB.run_microbench
    assert memory.sweep is TB.sweep
    assert memory.MicrobenchResult is TB.MicrobenchResult


def test_mesh_layout_and_os_config_match_reference():
    assert [(m.name, m.value) for m in TC.MeshLayout] == [
        (m.name, m.value) for m in RC.MeshLayout]
    for got, want in [(TC.OSConfig(), RC.OSConfig()),
                      (TC.OSConfig().tuned(), RC.OSConfig().tuned()),
                      (TC.OSConfig(page_tokens=64).tuned(),
                       RC.OSConfig(page_tokens=64).tuned())]:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(TC.OSConfig().tuned()) == dict(
        auto_rebalance=False, page_tokens=16, granule_bytes=4096)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TC.OSConfig().page_tokens = 1


def _pairs(n, seed):
    """Every pair of a small torus; 3000 seeded pairs of a large one."""
    if n <= 64:
        return [(a, b) for a in range(n) for b in range(n)]
    rng = np.random.RandomState(seed)
    return [tuple(map(int, p)) for p in rng.randint(0, n, (3000, 2))]


@pytest.mark.parametrize("shape", TORI)
def test_torus_geometry_matches_reference(shape):
    got, want = TT.TorusTopology(*shape), RT.TorusTopology(*shape)
    assert got.n_chips == want.n_chips
    for a, b in _pairs(got.n_chips, seed=sum(shape)):
        assert got.coord(a).__dict__ == want.coord(a).__dict__
        assert got.hop_distance(a, b) == want.hop_distance(a, b)
        assert got.relative_latency(a, b) == want.relative_latency(a, b)
    rng = np.random.RandomState(7)
    for size in (1, 2, 5, got.n_chips):
        ring = [int(x) for x in rng.permutation(got.n_chips)[:size]]
        assert TT.ring_neighbor_hops(got, ring) == \
            RT.ring_neighbor_hops(want, ring)


@pytest.mark.parametrize("shape", TORI)
def test_layout_report_matches_reference(shape):
    got = TMesh.layout_report(TT.TorusTopology(*shape))
    want = RMesh.layout_report(RT.TorusTopology(*shape))
    assert got == want
    for layout in TC.MeshLayout:
        np.testing.assert_array_equal(
            TMesh.layout_device_order(layout, TT.TorusTopology(*shape)),
            RMesh.layout_device_order(RC.MeshLayout(layout.value),
                                      RT.TorusTopology(*shape)))


@pytest.mark.parametrize("shape", TORI)
def test_cost_functions_match_reference_at_its_rates(shape):
    got_topo, want_topo = TT.TorusTopology(*shape), RT.TorusTopology(*shape)
    assert sorted(TT.COLLECTIVE_COSTS) == sorted(RT.COLLECTIVE_COSTS)
    order = TMesh.layout_device_order(TC.MeshLayout.NONE, got_topo)
    groups = [[0], [0, 1], list(range(got_topo.ydim)),
              [int(x) for x in order.reshape(-1)[:12]]]
    for name, fn in TT.COLLECTIVE_COSTS.items():
        for group in groups:
            for nbytes in (0, 1 << 20, 3 * 10**9):
                assert fn(nbytes, group, got_topo,
                          link_bw=RT.ICI_LINK_BW) == \
                    RT.COLLECTIVE_COSTS[name](nbytes, group, want_topo), \
                    (name, group, nbytes)
    for n_chips in (1, 8, 256):
        assert TT.compute_seconds(1e15, n_chips,
                                  peak_flops=RT.PEAK_FLOPS_BF16) == \
            RT.compute_seconds(1e15, n_chips)
        assert TT.memory_seconds(1e12, n_chips, hbm_bw=RT.HBM_BW) == \
            RT.memory_seconds(1e12, n_chips)
        assert TT.collective_seconds(1e11, n_chips,
                                     link_bw=RT.ICI_LINK_BW) == \
            RT.collective_seconds(1e11, n_chips)


def test_rates_are_required_arguments():
    topo = TT.TorusTopology(1, 4, 4)
    with pytest.raises(TypeError):
        TT.ring_allreduce_seconds(1 << 20, [0, 1], topo)
    with pytest.raises(TypeError):
        TT.compute_seconds(1e12, 1)


def test_port_holds_no_tpu_rate():
    """197e12 (bf16 FLOP/s), 819e9 (HBM bytes/s) and 50e9 (ICI link
    bytes/s) are the TPU's; no source of the port may carry them."""
    pat = re.compile(r"197e12|819e9|50e9")
    hits = []
    for d, _, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    hits += [f"{path}:{i}" for i, ln in enumerate(fh, 1)
                             if pat.search(ln)]
    assert not hits, hits


# ---------------------------------------------------------------------------
# the host's NUMA topology
# ---------------------------------------------------------------------------
def _fake_sysfs(root, distance, cpulists, gpus=()):
    """A sysfs tree of ``len(distance)`` nodes (ids from the cpulists'
    keys), and PCI devices {bus id: numa_node}."""
    nodes = sorted(cpulists)
    for i, n in enumerate(nodes):
        d = root / "devices" / "system" / "node" / f"node{n}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpulists[n] + "\n")
        (d / "distance").write_text(" ".join(map(str, distance[i])) + "\n")
    (root / "devices" / "system" / "node" / "possible").write_text("0-7\n")
    for bus, node in dict(gpus).items():
        d = root / "bus" / "pci" / "devices" / bus
        d.mkdir(parents=True)
        (d / "numa_node").write_text(f"{node}\n")
    return str(root)


def test_host_topology_of_two_nodes(tmp_path):
    root = _fake_sysfs(tmp_path, [[10, 21], [21, 10]],
                       {0: "0-3,8-11", 1: "4-7,12-15"},
                       gpus={"0000:3b:00.0": 1})
    topo = TT.read_host_topology(root, gpu_bus_id="00000000:3B:00.0")
    assert topo.nodes == (0, 1)
    assert topo.distance == ((10, 21), (21, 10))
    assert topo.cpulists == ("0-3,8-11", "4-7,12-15")
    assert topo.gpu_bus_id == "0000:3b:00.0" and topo.gpu_node == 1
    assert topo.relative_latency_table() == [[1.0, 2.1], [2.1, 1.0]]
    rep = topo.report()
    assert rep["gpu_node_cpulist"] == "4-7,12-15"
    assert rep["relative_latency"] == [[1.0, 2.1], [2.1, 1.0]]
    assert TT.read_host_topology(root).gpu_node is None


def test_host_topology_of_four_asymmetric_nodes(tmp_path):
    dist = [[10, 12, 20, 22], [12, 10, 22, 24], [20, 22, 10, 12],
            [23, 24, 12, 11]]
    root = _fake_sysfs(tmp_path, dist,
                       {0: "0-1", 1: "2-3", 2: "4-5", 3: "6,7"},
                       gpus={"0000:c1:00.0": 3})
    topo = TT.read_host_topology(root, gpu_bus_id="0000:C1:00.0")
    assert topo.nodes == (0, 1, 2, 3) and topo.gpu_node == 3
    assert topo.relative_latency(0, 1) == 1.2
    assert topo.relative_latency(1, 3) == 2.4
    assert topo.relative_latency(3, 0) == 23 / 11     # own row, own local
    assert topo.relative_latency(0, 3) == 2.2         # not symmetric
    assert topo.cpulists[3] == "6,7"
    with pytest.raises(KeyError):
        topo.relative_latency(0, 4)


def test_host_topology_keeps_a_card_without_a_node(tmp_path):
    root = _fake_sysfs(tmp_path, [[10]], {0: "0-7"},
                       gpus={"0000:18:00.0": -1})
    topo = TT.read_host_topology(root, gpu_bus_id="00000000:18:00.0")
    assert topo.gpu_node == -1
    assert topo.report()["gpu_node"] == -1
    assert topo.report()["gpu_node_cpulist"] is None


def test_host_topology_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        TT.read_host_topology(str(tmp_path))           # no node directory
    root = _fake_sysfs(tmp_path / "a", [[10, 20, 30], [20, 10, 30]],
                       {0: "0", 1: "1"})
    with pytest.raises(ValueError, match="entries"):
        TT.read_host_topology(root)                  # a short distance row
    root = _fake_sysfs(tmp_path / "b", [[10]], {0: "0-7"})
    with pytest.raises(FileNotFoundError):           # the card is not there
        TT.read_host_topology(root, gpu_bus_id="0000:18:00.0")
    root = _fake_sysfs(tmp_path / "c", [[10]], {0: "0-7"},
                       gpus={"0000:18:00.0": 2})
    with pytest.raises(ValueError, match="not one of"):
        TT.read_host_topology(root, gpu_bus_id="0000:18:00.0")


def test_host_topology_reads_this_machine():
    """The running machine's own sysfs, where it has one: every node has
    CPUs and a local distance no larger than any remote one."""
    if not os.path.isdir("/sys/devices/system/node"):
        with pytest.raises(FileNotFoundError):
            TT.read_host_topology()
        return
    topo = TT.read_host_topology()
    assert topo.nodes and len(topo.distance) == len(topo.nodes)
    for i, n in enumerate(topo.nodes):
        assert topo.relative_latency(n, n) == 1.0
        assert min(topo.distance[i]) == topo.distance[i][i]
    assert len(topo.cpulists) == len(topo.nodes)


@pytest.mark.parametrize("text,want", [
    ("00000000:3B:00.0", "0000:3b:00.0"), ("0000:c1:00.0", "0000:c1:00.0"),
    (" 00000001:18:00.1\n", "0001:18:00.1"), ("[N/A]", None), ("N/A", None)])
def test_sysfs_bus_id(text, want):
    assert TT.sysfs_bus_id(text) == want


def test_sysfs_bus_id_refuses_other_text():
    with pytest.raises(ValueError):
        TT.sysfs_bus_id("GPU-3b")


def test_parse_nvidia_topo():
    text = ("\t\x1b[4mGPU0\tNIC0\tCPU Affinity\tNUMA Affinity\t"
            "GPU NUMA ID\x1b[0m\n"
            "GPU0\t X \tSYS\t48-95,144-191\t1\t\tN/A\n"
            "NIC0\tSYS\t X \t\t\t\t\n\nLegend:\n\n  X    = Self\n")
    row = TT.parse_nvidia_topo(text)
    assert row["CPU Affinity"] == "48-95,144-191"
    assert row["NUMA Affinity"] == "1"
    assert row["GPU0"] == "X"
    with pytest.raises(ValueError):
        TT.parse_nvidia_topo("Failed to run topology matrix\n")
