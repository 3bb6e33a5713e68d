"""PyTorch/CUDA port of the VVC Matrix-based Intra Prediction (MIP) cost
engine, for one NVIDIA Hopper card.

The exhaustive MIP mode search over every candidate CU size/position of
every CTU of a frame, producing per-(CU, mode) SAD / SATD / minSadHad cost
tensors in the reference strided layout, from original or low-pass
filtered reference samples; the decisions-CSV export, the CLI
(``python -m vvc_mip_gpu_tpu_torch.cli``) and the inspect readbacks.
Each shape class runs through a hand-written CUDA kernel
(csrc/mip_cost.cu) on the GPU, or through the kernels' plain PyTorch
versions on the CPU; the inspect readback's reduced prediction runs
through csrc/mip_pred.cu.
"""

__version__ = "0.2.0"
