"""Topology models for the paper's NUMA axes.

The paper characterizes its machines by *relative NUMA node memory latency*
(Table 3: local 1.0, 1-hop 1.2 ... 3-hop 1.6 on its machine A) and by
interconnect bandwidth. This module holds two models of that:

* The torus geometry of ``repro.core.topology``: chips in pods, each pod
  an ``xdim`` x ``ydim`` wrap-around torus, with hop distances, the
  paper-style relative latency (local 1.0, +0.2 a hop) and ring-neighbour
  hop dilution. ``core.meshes`` prices its layouts on it. It is geometry:
  every function that turns bytes or operations into seconds takes its
  rate as a required keyword argument (``link_bw``, ``peak_flops``,
  ``hbm_bw``), and the module holds no device's rates.
* The NUMA topology of the host a card sits in, which is what Table 3
  describes: its nodes, each node's CPUs, the distance matrix and the
  card's node, read from the running machine's sysfs
  (``read_host_topology``). Nothing of it is written in by hand.
"""
from __future__ import annotations

import os
import re
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# torus geometry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TorusCoord:
    pod: int
    x: int
    y: int


@dataclass(frozen=True)
class TorusTopology:
    """``n_pods`` pods, each an ``xdim`` x ``ydim`` wrap-around torus."""

    n_pods: int = 1
    xdim: int = 16
    ydim: int = 16

    @property
    def chips_per_pod(self) -> int:
        return self.xdim * self.ydim

    @property
    def n_chips(self) -> int:
        return self.n_pods * self.chips_per_pod

    def coord(self, device_index: int) -> TorusCoord:
        pod, rem = divmod(device_index, self.chips_per_pod)
        x, y = divmod(rem, self.ydim)
        return TorusCoord(pod=pod, x=x, y=y)

    def hop_distance(self, a: int, b: int) -> float:
        """Torus manhattan distance; a cross-pod pair pays a full pod
        traverse (xdim + ydim hops) on top."""
        ca, cb = self.coord(a), self.coord(b)
        dx = min(abs(ca.x - cb.x), self.xdim - abs(ca.x - cb.x))
        dy = min(abs(ca.y - cb.y), self.ydim - abs(ca.y - cb.y))
        pod_penalty = 0.0
        if ca.pod != cb.pod:
            pod_penalty = self.xdim + self.ydim
        return dx + dy + pod_penalty

    def relative_latency(self, a: int, b: int) -> float:
        """Paper-style relative access latency (local = 1.0)."""
        return 1.0 + 0.2 * self.hop_distance(a, b)


def ring_neighbor_hops(topo: TorusTopology, ring: Sequence[int]) -> float:
    """Mean torus hop distance between successive ring members.

    1.0 means the logical ring is a physical ring (each transfer is one
    hop); larger values mean each ring step crosses several links and so
    divides the effective bandwidth."""
    n = len(ring)
    if n <= 1:
        return 0.0
    total = 0.0
    for i in range(n):
        total += topo.hop_distance(ring[i], ring[(i + 1) % n])
    return total / n


# ---------------------------------------------------------------------------
# collective cost model: seconds at a given link rate (bytes/s a link)
# ---------------------------------------------------------------------------
def ring_allreduce_seconds(nbytes: int, group: Sequence[int],
                           topo: TorusTopology, *, link_bw: float) -> float:
    """Bidirectional-ring all-reduce: 2*(n-1)/n of the buffer crosses each
    link; hop dilution divides effective bandwidth."""
    n = len(group)
    if n <= 1:
        return 0.0
    hops = max(1.0, ring_neighbor_hops(topo, group))
    eff_bw = 2 * link_bw / hops            # both directions of the ring
    return 2.0 * nbytes * (n - 1) / n / eff_bw


def all_gather_seconds(nbytes: int, group: Sequence[int],
                       topo: TorusTopology, *, link_bw: float) -> float:
    n = len(group)
    if n <= 1:
        return 0.0
    hops = max(1.0, ring_neighbor_hops(topo, group))
    eff_bw = 2 * link_bw / hops
    return nbytes * (n - 1) / n / eff_bw


def all_to_all_seconds(nbytes: int, group: Sequence[int],
                       topo: TorusTopology, *, link_bw: float) -> float:
    """All-to-all moves (n-1)/n of the buffer, bisection-limited."""
    n = len(group)
    if n <= 1:
        return 0.0
    hops = max(1.0, ring_neighbor_hops(topo, group))
    eff_bw = 4 * link_bw / hops            # bisection of a 2-link ring
    return nbytes * (n - 1) / n / eff_bw


def collective_permute_seconds(nbytes: int, group: Sequence[int],
                               topo: TorusTopology, *,
                               link_bw: float) -> float:
    """One link's transfer of the buffer (the reference's hop factor is
    max(1, 1/max(1, hops)), always 1)."""
    return nbytes / link_bw if len(group) > 1 else 0.0


COLLECTIVE_COSTS = {
    "all-reduce": ring_allreduce_seconds,
    "all-gather": all_gather_seconds,
    "reduce-scatter": all_gather_seconds,   # same wire bytes as all-gather
    "all-to-all": all_to_all_seconds,
    "collective-permute": collective_permute_seconds,
}


def compute_seconds(total_flops: float, n_chips: int, *,
                    peak_flops: float) -> float:
    return total_flops / (n_chips * peak_flops)


def memory_seconds(total_bytes: float, n_chips: int, *,
                   hbm_bw: float) -> float:
    return total_bytes / (n_chips * hbm_bw)


def collective_seconds(total_bytes: float, n_chips: int, *,
                       link_bw: float) -> float:
    """Flat form: bytes / (chips x link_bw)."""
    return total_bytes / (n_chips * link_bw)


# ---------------------------------------------------------------------------
# the host's NUMA topology (paper Table 3), read from sysfs
# ---------------------------------------------------------------------------
NODE_DIR = ("devices", "system", "node")
_BUS_ID = re.compile(r"^[0-9a-f]{4}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]$")


def sysfs_bus_id(bus_id: str) -> Optional[str]:
    """A PCI bus id in the ``dddd:bb:dd.f`` form of
    ``/sys/bus/pci/devices``: lower case, the domain cut to its last four
    digits (nvidia-smi prints eight). None for ``N/A`` (a card whose
    driver does not report it)."""
    s = bus_id.strip().lower().strip("[]")
    if s == "n/a":
        return None
    domain, sep, rest = s.partition(":")
    out = f"{domain[-4:]}:{rest}" if sep and len(domain) >= 4 else s
    if not _BUS_ID.match(out):
        raise ValueError(f"not a PCI bus id: {bus_id!r}")
    return out


def nvidia_smi_bus_id(index: int = 0) -> Optional[str]:
    """The card's bus id as nvidia-smi reports it, in sysfs form (None
    when the driver reports ``N/A``)."""
    out = subprocess.run(["nvidia-smi", f"--id={index}",
                          "--query-gpu=pci.bus_id", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return sysfs_bus_id(out.stdout.strip().splitlines()[0])


@dataclass(frozen=True)
class HostTopology:
    """NUMA nodes of a host, as sysfs reports them.

    ``distance[i][j]`` is the SLIT distance from ``nodes[i]`` to
    ``nodes[j]`` (local is conventionally 10); ``cpulists[i]`` is the
    cpulist of ``nodes[i]``. ``gpu_node`` is the card's node from its PCI
    device's ``numa_node``: -1 where sysfs reports none (as on a host of
    one node), None when no card was named."""

    nodes: Tuple[int, ...]
    cpulists: Tuple[str, ...]
    distance: Tuple[Tuple[int, ...], ...]
    gpu_bus_id: Optional[str] = None
    gpu_node: Optional[int] = None

    def _index(self, node: int) -> int:
        try:
            return self.nodes.index(node)
        except ValueError:
            raise KeyError(f"no NUMA node {node} (nodes "
                           f"{list(self.nodes)})") from None

    def relative_latency(self, a: int, b: int) -> float:
        """The paper's relative latency: distance(a, b) / distance(a, a),
        so a node's own memory reads 1.0."""
        row = self.distance[self._index(a)]
        return row[self._index(b)] / row[self._index(a)]

    def relative_latency_table(self) -> List[List[float]]:
        return [[self.relative_latency(a, b) for b in self.nodes]
                for a in self.nodes]

    def report(self) -> Dict[str, object]:
        """Everything read, plus the relative-latency table and the card
        node's CPUs (None when the card has no node)."""
        node = self.gpu_node
        return dict(nodes=list(self.nodes), cpulists=list(self.cpulists),
                    distance=[list(r) for r in self.distance],
                    relative_latency=self.relative_latency_table(),
                    gpu_bus_id=self.gpu_bus_id, gpu_node=node,
                    gpu_node_cpulist=(self.cpulists[self._index(node)]
                                      if node is not None and node >= 0
                                      else None))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def read_host_topology(root: str = "/sys",
                       gpu_bus_id: Optional[str] = None) -> HostTopology:
    """The host's NUMA topology from ``<root>/devices/system/node`` and,
    given the card's bus id (any case, nvidia-smi's or sysfs's form),
    the card's node from ``<root>/bus/pci/devices/<id>/numa_node``.

    Raises FileNotFoundError when the node directory, a node's files or
    the card's device entry are missing, and ValueError when a distance
    row does not cover every node: it never assumes a one-node host."""
    node_dir = os.path.join(root, *NODE_DIR)
    if not os.path.isdir(node_dir):
        raise FileNotFoundError(f"no NUMA node directory {node_dir}")
    nodes = tuple(sorted(int(m.group(1)) for m in
                         (re.fullmatch(r"node(\d+)", e)
                          for e in os.listdir(node_dir)) if m))
    if not nodes:
        raise FileNotFoundError(f"no node<N> entry under {node_dir}")
    cpulists, distance = [], []
    for n in nodes:
        d = os.path.join(node_dir, f"node{n}")
        cpulists.append(_read(os.path.join(d, "cpulist")))
        row = tuple(int(x) for x in _read(os.path.join(d, "distance")).split())
        if len(row) != len(nodes):
            raise ValueError(f"node{n}/distance has {len(row)} entries for "
                             f"{len(nodes)} nodes")
        distance.append(row)
    bus, gpu_node = None, None
    if gpu_bus_id is not None:
        bus = sysfs_bus_id(gpu_bus_id)
        if bus is None:
            raise ValueError(f"no bus id in {gpu_bus_id!r}")
        gpu_node = int(_read(os.path.join(root, "bus", "pci", "devices", bus,
                                          "numa_node")))
        if gpu_node != -1 and gpu_node not in nodes:
            raise ValueError(f"card {bus} on node {gpu_node}, not one of "
                             f"{list(nodes)}")
    return HostTopology(nodes, tuple(cpulists), tuple(distance), bus,
                        gpu_node)


def parse_nvidia_topo(text: str, gpu: str = "GPU0") -> Dict[str, str]:
    """The row of ``gpu`` in ``nvidia-smi topo -m``'s matrix, keyed by the
    header's column names (such as "CPU Affinity", "NUMA Affinity")."""
    clean = re.sub(r"\x1b\[[0-9;]*m", "", text)
    lines = [ln for ln in clean.splitlines() if ln.strip()]
    header = next((ln for ln in lines if "Affinity" in ln), None)
    row = next((ln for ln in lines if ln.split("\t")[0].strip() == gpu),
               None)
    if header is None or row is None:
        raise ValueError(f"no matrix with a {gpu} row in: {text!r}")
    cols = [c.strip() for c in header.split("\t")]
    cells = [c.strip() for c in row.split("\t")]
    return {name: cells[i] for i, name in enumerate(cols)
            if name and i < len(cells)}
