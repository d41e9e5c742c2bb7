from repro_torch.kernels.join_probe.ops import join_probe
