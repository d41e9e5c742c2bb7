"""Per-layer metrics: one module each, found by the name in BENCHMARK.json."""
