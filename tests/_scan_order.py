"""A torch model of the order in which the rglru_scan CUDA kernel
(``csrc/rglru_scan.cu``) computes ``h_t = a_t * h_{t-1} + b_t``.

Shared by the CPU tests of that order (``test_torch_scan_order.py``) and
the kernel's tests on a card (``test_torch_cuda.py``, which hold the
kernel's output to this model's bits). The order, from the kernel's note:

* time is cut into runs of ``run`` steps from step 0 (a warp's run; the
  last may be short);
* each run's product of a, ``P_r``, and its end value from h = 0, ``E_r``,
  are taken step by step: ``E = a_t * E + b_t``, ``P = P * a_t`` from
  ``P = 1``, ``E = 0``;
* the h that enters run r + 1 is ``P_r * h_r + E_r``, from ``h_0 = 0``, in
  run order (a chunk's published carry is this fold at its end, so chunk
  boundaries do not change it);
* each run is then applied from its entering h, step by step.

Every multiply and add is rounded on its own, as ``__fmul_rn`` and
``__fadd_rn`` in the kernel and the eager ``a * h + b`` in torch.
"""
import torch


def kernel_order_scan(a: torch.Tensor, b: torch.Tensor,
                      run: int) -> torch.Tensor:
    """a, b: (B, S, D). Returns float32 h in the kernel's order for runs
    of ``run`` steps."""
    a, b = a.float(), b.float()
    B, S, D = a.shape
    n = -(-S // run)
    pad = n * run - S
    if pad:                 # steps past the end: a = 1, b = 0, cut below
        a = torch.cat([a, a.new_ones((B, pad, D))], 1)
        b = torch.cat([b, b.new_zeros((B, pad, D))], 1)
    ar, br = a.unflatten(1, (n, run)), b.unflatten(1, (n, run))
    p, e = a.new_ones((B, n, D)), a.new_zeros((B, n, D))
    for j in range(run):                      # every run's (P, E) at once
        e = ar[:, :, j] * e + br[:, :, j]
        p = p * ar[:, :, j]
    enter = torch.empty_like(p)
    h = a.new_zeros((B, D))
    for r in range(n):                        # the fold, in run order
        enter[:, r] = h
        h = p[:, r] * h + e[:, r]
    out = torch.empty_like(ar)
    h = enter
    for j in range(run):                      # every run applied at once
        h = ar[:, :, j] * h + br[:, :, j]
        out[:, :, j] = h
    return out.flatten(1, 2)[:, :S]
