"""Benchmark helpers of the PyTorch/CUDA port (``bench_torch.py``), beside
the JAX package's ``benchmarks/``."""
