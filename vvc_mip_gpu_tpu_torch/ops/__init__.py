"""PyTorch ops and CUDA cost kernels for the MIP pipeline."""
