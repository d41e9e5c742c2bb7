from repro_torch.kernels.rglru_scan.ops import linear_scan
