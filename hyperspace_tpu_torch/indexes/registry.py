"""Polymorphic index (de)serialization registry.

Plays the role of Jackson's ``@JsonTypeInfo(use=Id.CLASS)`` on the
reference's ``Index`` trait (``index/Index.scala:25-30``): the JSON carries
a ``"type"`` discriminator; this registry maps it back to the class.
"""

from __future__ import annotations

from typing import Dict, Type

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.indexes.base import Index

_REGISTRY: Dict[str, Type[Index]] = {}


def register_index(cls: Type[Index]) -> Type[Index]:
    _REGISTRY[cls.kind] = cls
    return cls


def _ensure_builtin_kinds_loaded() -> None:
    # Importing the modules runs their @register_index decorators. Only a
    # module genuinely not existing yet is tolerated; transitive import
    # failures inside an existing module must propagate.
    import importlib

    for mod in (
        "hyperspace_tpu_torch.indexes.covering",
        "hyperspace_tpu_torch.indexes.zorder",
        "hyperspace_tpu_torch.indexes.dataskipping",
    ):
        try:
            importlib.import_module(mod)
        except ModuleNotFoundError as e:
            if e.name != mod:
                raise


def index_from_dict(d: dict) -> Index:
    _ensure_builtin_kinds_loaded()
    kind = d.get("type")
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise HyperspaceException(f"Unknown index kind: {kind!r}")
    return cls.from_dict(d)
