"""Index type registry, the port of vearch_tpu/index/registry.py. Index
modules self-register at import (the reference's index/builtin.py
imports); `create_index` is the engine's only entry point."""

from __future__ import annotations

from typing import Callable, Type

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams
from vearch_tpu_torch.index.base import VectorIndex

_REGISTRY: dict[str, Type[VectorIndex]] = {}

#: the reference's index types this port does not serve yet, each with
#: the ROADMAP queue 1 item that ports it
NOT_PORTED: dict[str, str] = {
    "FLAT_SHARDED": "multi-device, ROADMAP queue 1 item 10",
}


def register_index(name: str) -> Callable[[Type[VectorIndex]], Type[VectorIndex]]:
    def deco(cls: Type[VectorIndex]) -> Type[VectorIndex]:
        _REGISTRY[name.upper()] = cls
        return cls

    return deco


def _import_builtins() -> None:
    import vearch_tpu_torch.index.binary  # noqa: F401
    import vearch_tpu_torch.index.disk  # noqa: F401
    import vearch_tpu_torch.index.flat  # noqa: F401
    import vearch_tpu_torch.index.hnsw  # noqa: F401
    import vearch_tpu_torch.index.ivf  # noqa: F401
    import vearch_tpu_torch.index.scann  # noqa: F401


def create_index(params: IndexParams, store: RawVectorStore) -> VectorIndex:
    name = params.index_type.upper()
    if name == "FLAT" and params.get("sharded"):
        name = "FLAT_SHARDED"  # the reference's multi-chip FLAT
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"index_type {name} is not ported yet ({NOT_PORTED[name]})")
    if name not in _REGISTRY:
        _import_builtins()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown index_type {params.index_type!r}; "
            f"registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](params, store)
