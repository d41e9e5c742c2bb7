from repro_torch.kernels.radix_probe.ops import radix_probe
