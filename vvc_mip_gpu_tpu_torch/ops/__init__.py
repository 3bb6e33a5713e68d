"""PyTorch ops, filters and the CUDA kernels of the MIP pipeline."""
