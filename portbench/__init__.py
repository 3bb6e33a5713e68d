"""Benchmark of the PyTorch and CUDA MIP cost engine: one cell (a
configuration under a traffic mix) per run; see README.md."""
