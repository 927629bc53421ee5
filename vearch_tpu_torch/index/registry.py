"""Index type registry, the port of vearch_tpu/index/registry.py. Index
modules self-register at import (index/builtin.py); `create_index` is the
engine's only entry point."""

from __future__ import annotations

from typing import Callable, Type

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams
from vearch_tpu_torch.index.base import VectorIndex

_REGISTRY: dict[str, Type[VectorIndex]] = {}


def register_index(name: str) -> Callable[[Type[VectorIndex]], Type[VectorIndex]]:
    def deco(cls: Type[VectorIndex]) -> Type[VectorIndex]:
        _REGISTRY[name.upper()] = cls
        return cls

    return deco


def create_index(params: IndexParams, store: RawVectorStore) -> VectorIndex:
    name = params.index_type.upper()
    if name == "FLAT" and params.get("sharded"):
        name = "FLAT_SHARDED"  # the multi-device FLAT
    if name not in _REGISTRY:
        import vearch_tpu_torch.index.builtin  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown index_type {params.index_type!r}; "
            f"registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](params, store)


def registered_types() -> list[str]:
    import vearch_tpu_torch.index.builtin  # noqa: F401

    return sorted(_REGISTRY)
