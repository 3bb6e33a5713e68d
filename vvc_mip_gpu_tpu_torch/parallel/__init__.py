"""Multi-device parallelism: device meshes, sharded engines, halo rows."""

from vvc_mip_gpu_tpu_torch.parallel.mesh import make_mesh
from vvc_mip_gpu_tpu_torch.parallel.sharded_engine import ShardedMipCostEngine

__all__ = ["make_mesh", "ShardedMipCostEngine"]
