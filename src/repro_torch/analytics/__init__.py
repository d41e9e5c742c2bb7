"""Single-device TPC-H analytics engine on PyTorch (logical plan ->
physical plan -> columnar operators -> CUDA kernels)."""
