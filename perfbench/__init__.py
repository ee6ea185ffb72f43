"""The benchmark of `repro_torch`, the PyTorch and CUDA port: its serving
engine on an NVIDIA H100.  `run.py` runs one cell of `BENCHMARK.json`;
PERF.md describes the cells, metrics and limits."""
