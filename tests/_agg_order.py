"""A torch model of the order in which the hash_aggregate CUDA kernel
(``csrc/hash_aggregate.cu``) adds its rows, and q18-like inputs for it.

Shared by the CPU tests of that order (``test_torch_kernel_orders.py``)
and the kernel's tests on a card (``test_torch_cuda.py``, which hold the
kernel's output to this model's bits). The order, from the kernel's note:

* a partition's rows are cut into chunks (``launch_plan``) and a chunk's
  rows into 32-row groups from the chunk's first row;
* a row takes part only if its id is in range and one of its values is
  not +-0; within a group, the rows of one bin are summed by a fixed tree
  over their ranks in row order (rank r takes rank r + s at s = 1, 2, 4,
  ...);
* with private tables (``private``), group g goes to warp g mod 8, each
  warp adds its groups' sums into its own table in group order, and the
  eight tables are added in warp order; otherwise the table entry of a bin
  takes its groups' sums in group order;
* the chunks' tables are added in chunk order.
"""
import numpy as np
import torch

from repro_torch.kernels.hash_aggregate.ops import WARPS, launch_plan

GROUP = 32


def tree_sums(groups, bins, vals):
    """Per (group, bin) of the participating rows (given in row order):
    the tree over ranks. Returns (group, bin, sum (n, C) float32)."""
    n, C = vals.shape
    if n == 0:
        return groups, bins, vals
    order = torch.argsort(groups * (int(bins.max()) + 1) + bins, stable=True)
    g, b, v = groups[order], bins[order], vals[order]
    new = torch.ones(n, dtype=torch.bool)
    new[1:] = (g[1:] != g[:-1]) | (b[1:] != b[:-1])
    seg = torch.cumsum(new.long(), 0) - 1
    starts = torch.nonzero(new).flatten()
    rank = torch.arange(n) - starts[seg]
    tree = torch.zeros((len(starts), GROUP, C), dtype=torch.float32)
    tree[seg, rank] = v
    s = 1
    while s < GROUP:
        tree[:, 0::2 * s] += tree[:, s::2 * s]
        s *= 2
    return g[starts], b[starts], tree[:, 0]


def fold(keys, order, sums, n_keys):
    """t[k] = ((+0 + s_1) + s_2) + ... over the sums of key k in ascending
    ``order``, in float32. Returns (n_keys, C)."""
    t = torch.zeros((n_keys, sums.shape[1]), dtype=torch.float32)
    if len(keys) == 0:
        return t
    idx = torch.argsort(order, stable=True)
    idx = idx[torch.argsort(keys[idx], stable=True)]
    k, s = keys[idx], sums[idx]
    new = torch.ones(len(k), dtype=torch.bool)
    new[1:] = k[1:] != k[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    pos = torch.arange(len(k)) - torch.nonzero(new).flatten()[run]
    by_pos = torch.argsort(pos, stable=True)
    for sel in torch.split(by_pos, torch.bincount(pos).tolist()):
        t[k[sel]] = t[k[sel]] + s[sel]
    return t


def chunk_table(ids, vals, n_bins, private):
    """One chunk's table (n_bins, C): ids (R,) int, vals (R, C) float32."""
    ok = (ids >= 0) & (ids < n_bins) & (vals != 0).any(dim=1)
    rows = torch.nonzero(ok).flatten()
    g, b, s = tree_sums(rows // GROUP, ids[rows].long(), vals[rows])
    if not private:
        return fold(b, g, s, n_bins)
    tables = fold((g % WARPS) * n_bins + b, g, s, WARPS * n_bins)
    tables = tables.reshape(WARPS, n_bins, -1)
    out = tables[0]
    for w in range(1, WARPS):
        out = out + tables[w]
    return out


def kernel_order_sums(ids, vals, n_bins, plan=None, n_sms=132):
    """The kernel's (P, n_bins, C) float32 sums, in its order, on the CPU.
    ``plan`` is ``launch_plan``'s (tile_bins, n_chunks, rows_per_chunk,
    private); by default the plan the kernel takes for these shapes on a
    card of ``n_sms`` SMs."""
    ids, vals = ids.cpu(), vals.cpu().float()
    P, T = ids.shape
    C = vals.shape[2]
    if plan is None:
        plan = launch_plan(P, T, C, n_bins, n_sms)
    _, n_chunks, rows, private = plan
    out = torch.empty((P, n_bins, C), dtype=torch.float32)
    for p in range(P):
        acc = None
        for ch in range(n_chunks):
            r0, r1 = ch * rows, min((ch + 1) * rows, T)
            part = chunk_table(ids[p, r0:r1], vals[p, r0:r1], n_bins,
                               private)
            acc = part if acc is None else acc + part
        out[p] = acc
    return out


def q18_like(seed, n_rows=187_648, n_bins=23_552, fill=0.5,
             in_order=False):
    """One partition of q18's aggregate at SF1 as numpy arrays: orders of 1
    to 7 lineitem rows, each order a slot of [0, n_bins), the rows in
    random order (the port's l_orderkey is uniform), or with
    ``in_order`` each order's rows adjacent and the slots ascending;
    values (l_extendedprice, l_quantity) of TPC-H's magnitudes (quantity
    1-50 times a part price of 900-2100); then padding rows (slot 0,
    values 0) up to ``n_rows``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 8, n_bins)
    lens = lens[:np.searchsorted(np.cumsum(lens), int(n_rows * fill))]
    slots = np.repeat(np.sort(rng.choice(n_bins, len(lens), replace=False)),
                      lens)
    ids = np.zeros(n_rows, np.int32)
    ids[:lens.sum()] = slots if in_order else rng.permutation(slots)
    qty = rng.randint(1, 51, n_rows).astype(np.float32)
    price = (qty * rng.uniform(900, 2100, n_rows)).astype(np.float32)
    vals = np.stack([price, qty], axis=1)
    vals[lens.sum():] = 0.0
    return ids, vals
