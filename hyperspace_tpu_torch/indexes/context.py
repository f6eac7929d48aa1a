"""IndexerContext — everything an index build step needs.

Reference: ``index/IndexerContext.scala:25-43`` (spark session, shared
FileIdTracker, index data path). The device the build runs on is the
session's (``session.device``); the multi-device mesh of the JAX package
is ported with the multi-GPU build (ROADMAP queue A item 9).
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.metadata.entry import FileIdTracker


@dataclasses.dataclass
class IndexerContext:
    session: object
    file_id_tracker: FileIdTracker
    index_data_path: str

    @property
    def device(self):
        return self.session.device
