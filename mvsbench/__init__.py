"""The benchmark of ``transmvsnet_tpu_torch`` on one NVIDIA H100: cells of
BENCHMARK.json run by ``python -m mvsbench.run`` (see README.md)."""
