"""Index type registry, the port of vearch_tpu/index/registry.py. Index
modules self-register at import; `create_index` is the engine's only
entry point."""

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


def _import_builtins() -> None:
    import vearch_tpu_torch.index.flat  # noqa: F401
    import vearch_tpu_torch.index.ivf  # noqa: F401


def create_index(params: IndexParams, store: RawVectorStore) -> VectorIndex:
    name = params.index_type.upper()
    if name not in _REGISTRY:
        _import_builtins()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"index_type {params.index_type!r} is not ported yet (ROADMAP "
            f"queue 1); ported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](params, store)
