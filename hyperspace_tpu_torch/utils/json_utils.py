"""JSON (de)serialization helpers.

Reference: ``util/JsonUtils.scala`` (Jackson wrapper). Polymorphism (the
reference's ``@JsonTypeInfo`` on ``Index``/``Sketch``) is handled by a
``"type"`` discriminator key written/read by the registries in
:mod:`hyperspace_tpu_torch.indexes` and the sketch registry.
"""

from __future__ import annotations

import json
from typing import Any


def to_json(obj: Any, indent: int | None = None) -> str:
    return json.dumps(obj, sort_keys=True, indent=indent)


def from_json(text: str) -> Any:
    return json.loads(text)
