"""The port's benchmark: BENCHMARK.json's cells, run one at a time by
``bench/run.py``. See README.md."""
