"""Data parallelism over ``torch.distributed``: port of ``ic_gan_tpu/parallel``."""

from ic_gan_tpu_torch.parallel import collectives, mesh, stats
from ic_gan_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

__all__ = ["collectives", "mesh", "stats", "Mesh", "make_mesh", "shard_batch"]
