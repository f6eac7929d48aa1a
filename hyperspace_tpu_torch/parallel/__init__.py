"""Distributed layer: the shard mesh, the bucket exchange and the
collectives of a multi-process job.

Counterpart of ``hyperspace_tpu/parallel``. The reference runs XLA
collectives over a ``jax.sharding.Mesh``; the port's mesh is a list of
torch devices, one a shard (one device may hold several shards), and the
exchange between shards in one process is a copy of ``[D, cap]`` blocks
between them (kernels B8a and B8b around it, ``ops/exchange.py``). A job of
several processes joins through ``torch.distributed``
(:func:`.mesh.initialize_distributed`).
"""

from hyperspace_tpu_torch.parallel.mesh import MeshRuntime, default_mesh
from hyperspace_tpu_torch.parallel.shuffle import bucket_shuffle

__all__ = ["MeshRuntime", "default_mesh", "bucket_shuffle"]
