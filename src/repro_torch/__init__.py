"""PyTorch and CUDA port of the ``repro`` analytics engine.

A package of its own beside ``repro``: it imports ``torch`` and never
``jax``, and nothing of ``repro``. Its entry points run on a CUDA device
unless the caller asks for the CPU (``device="cpu"``); every Pallas
kernel on its path is a CUDA kernel written by hand for Hopper
(``repro_torch.kernels``), with a plain PyTorch version beside it.
"""
