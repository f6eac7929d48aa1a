"""IndexerContext — everything an index build step needs.

Reference: ``index/IndexerContext.scala:25-43`` (spark session, shared
FileIdTracker, index data path). Beside the session's device it holds
the build's shard mesh: the session's (``session.runtime``), capped by
``hyperspace.build.numShards``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from hyperspace_tpu_torch.metadata.entry import FileIdTracker


@dataclasses.dataclass
class IndexerContext:
    session: object
    file_id_tracker: FileIdTracker
    index_data_path: str
    _build_mesh: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self):
        return self.session.device

    @property
    def mesh(self):
        """The build-plane mesh: the session's, capped to its first
        ``hyperspace.build.numShards`` shards when that is set (0 = all).
        Memoized, so every stage of one action sees one mesh. A job of
        several processes keeps its whole mesh (every process must build
        over the same shards)."""
        if self._build_mesh is None:
            mesh = self.session.runtime.mesh
            n = self.session.conf.build_num_shards
            if mesh.processes == 1 and 0 < n < mesh.size:
                from hyperspace_tpu_torch.parallel.mesh import default_mesh

                mesh = default_mesh(mesh.local_devices[:n])
            self._build_mesh = mesh
        return self._build_mesh
