"""Engine models assembled from the ops layer."""

from vvc_mip_gpu_tpu_torch.models.cost_engine import FrameCosts, MipCostEngine

__all__ = ["FrameCosts", "MipCostEngine"]
