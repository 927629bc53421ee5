"""gRPC front door for the router (reference: internal/router/server.go:92
— the reference raises a gRPC server on `rpc_port` next to the HTTP
gateway; its IDL lives in internal/proto). Here the service is defined by
`api/vearch.proto` (an original IDL: JSON payloads for schema-dependent
parts, packed floats for query vectors) and served by grpcio using
explicit method handlers — the image ships protoc but not the gRPC
python plugin, so message classes are protoc-generated while the service
table is registered by hand (grpc.method_handlers_generic_handler).

Generated code is cached next to this module, keyed on the .proto's
sha256 (same no-stale-binary discipline as vearch_tpu_torch/native).

The port's departure: where protoc is missing, the message classes are
built from `vearch_proto.desc` beside this module, the descriptor set
protoc writes for api/vearch.proto (`protoc -Iapi
--descriptor_set_out=vearch_tpu_torch/cluster/vearch_proto.desc
api/vearch.proto`; tests/test_torch_operator.py holds it equal to
protoc's), so a router serves gRPC on a machine with grpcio and protobuf
but no protoc."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import threading
from typing import Any

from vearch_tpu_torch.cluster.rpc import RpcError

_PROTO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "api",
    "vearch.proto",
)
_GEN_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".proto_cache"
)
_DESCRIPTOR_SET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "vearch_proto.desc"
)
_lock = threading.Lock()
_pb2_mod = None


def load_pb2():
    """protoc-generate (if stale) and import vearch_pb2."""
    global _pb2_mod
    with _lock:
        if _pb2_mod is not None:
            return _pb2_mod
        with open(_PROTO, "rb") as f:
            src = f.read()
        h = hashlib.sha256(src).hexdigest()
        os.makedirs(_GEN_DIR, exist_ok=True)
        gen = os.path.join(_GEN_DIR, "vearch_pb2.py")
        hfile = gen + ".srchash"
        stale = True
        if os.path.exists(gen) and os.path.exists(hfile):
            with open(hfile) as f:
                stale = f.read().strip() != h
        if stale and shutil.which("protoc") is None:
            _pb2_mod = pb2_from_descriptor_set()
            return _pb2_mod
        if stale:
            subprocess.run(
                ["protoc", f"-I{os.path.dirname(_PROTO)}",
                 f"--python_out={_GEN_DIR}", _PROTO],
                check=True, capture_output=True, timeout=60,
            )
            with open(hfile, "w") as f:
                f.write(h)
        spec = importlib.util.spec_from_file_location("vearch_pb2", gen)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _pb2_mod = mod
        return mod


def pb2_from_descriptor_set(path: str = _DESCRIPTOR_SET):
    """A module holding api/vearch.proto's message classes, built from the
    descriptor set at `path` in a pool of its own (no protoc)."""
    import types

    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    with open(path, "rb") as f:
        fds = descriptor_pb2.FileDescriptorSet.FromString(f.read())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    mod = types.ModuleType("vearch_pb2")
    mod.DESCRIPTOR = pool.FindFileByName("vearch.proto")
    for name, desc in mod.DESCRIPTOR.message_types_by_name.items():
        setattr(mod, name, message_factory.GetMessageClass(desc))
    return mod


# RpcError HTTP codes -> canonical gRPC status codes
_STATUS = {
    400: "INVALID_ARGUMENT",
    401: "UNAUTHENTICATED",
    403: "PERMISSION_DENIED",
    404: "NOT_FOUND",
    409: "ABORTED",
    503: "UNAVAILABLE",
}


def _loads(s: str, what: str, want: type = dict) -> Any:
    """Parse a JSON payload field and enforce its top-level shape, so a
    malformed client payload maps to INVALID_ARGUMENT — not a TypeError
    escaping as UNKNOWN."""
    if not s:
        return None
    try:
        out = json.loads(s)
    except ValueError:
        raise RpcError(400, f"invalid JSON in {what}") from None
    if not isinstance(out, want):
        names = (want.__name__ if isinstance(want, type)
                 else "/".join(t.__name__ for t in want))
        raise RpcError(
            400, f"{what} must be a JSON {names}, "
                 f"got {type(out).__name__}")
    return out


class GrpcRouter:
    """gRPC server bound to a RouterServer's handler internals: each RPC
    converts proto -> the HTTP handlers' body dicts and back, so both
    front doors share validation, routing, merging, and tracing."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 32):
        import grpc
        from concurrent import futures

        self.router = router
        self.pb2 = load_pb2()
        self._grpc = grpc
        self.server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="grpc-router",
            )
        )
        pb2 = self.pb2

        def handler(fn, req_cls, resp_cls, http_path):
            def call(request, context):
                try:
                    # same BasicAuth + per-endpoint privilege enforcement
                    # as the HTTP front door (an auth-enabled cluster
                    # must not be writable through an unauthenticated
                    # side entrance). Credentials ride the standard
                    # `authorization` metadata key.
                    authenticator = self.router.server.authenticator
                    if authenticator is not None:
                        md = {k: v for k, v in
                              (context.invocation_metadata() or ())}
                        headers = {
                            "Authorization": md.get("authorization", "")
                        }
                        authenticator(headers, "POST", http_path)
                    return fn(request)
                except RpcError as e:
                    context.abort(
                        getattr(grpc.StatusCode,
                                _STATUS.get(e.code, "INTERNAL")),
                        e.msg,
                    )
            return grpc.unary_unary_rpc_method_handler(
                call,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )

        service = grpc.method_handlers_generic_handler(
            "vearch_tpu.Router",
            {
                "Upsert": handler(self._upsert, pb2.UpsertRequest,
                                  pb2.UpsertResponse, "/document/upsert"),
                "Search": handler(self._search, pb2.SearchRequest,
                                  pb2.SearchResponse, "/document/search"),
                "Query": handler(self._query, pb2.QueryRequest,
                                 pb2.QueryResponse, "/document/query"),
                "Delete": handler(self._delete, pb2.DeleteRequest,
                                  pb2.DeleteResponse, "/document/delete"),
            },
        )
        self.server.add_generic_rpc_handlers((service,))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            # grpc reports bind failure by returning port 0, not raising
            raise OSError(f"gRPC bind failed on {host}:{port}")
        self.addr = f"{host}:{self.port}"

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=1.0)

    # -- RPC implementations -------------------------------------------------

    def _upsert(self, req):
        docs = []
        for d in req.documents:
            fields = _loads(d.fields_json, "fields_json") or {}
            if d.id:
                fields["_id"] = d.id
            docs.append(fields)
        out = self.router._h_upsert(
            {"db_name": req.db_name, "space_name": req.space_name,
             "documents": docs}, None)
        return self.pb2.UpsertResponse(
            total=out["total"], document_ids=out["document_ids"])

    def _search(self, req):
        import numpy as np

        body: dict[str, Any] = {
            "db_name": req.db_name,
            "space_name": req.space_name,
            # np.asarray reads the packed repeated-scalar container
            # directly — no intermediate PyFloat list on the hot path
            "vectors": [
                {"field": v.field,
                 "feature": np.asarray(v.feature, dtype=np.float32),
                 **({"min_score": v.min_score}
                    if v.HasField("min_score") else {}),
                 **({"max_score": v.max_score}
                    if v.HasField("max_score") else {}),
                 **({"boost": v.boost} if v.HasField("boost") else {})}
                for v in req.vectors
            ],
        }
        if req.HasField("limit"):
            body["limit"] = req.limit
        if req.filters_json:
            body["filters"] = _loads(req.filters_json, "filters_json")
        if req.fields:
            body["fields"] = list(req.fields)
        if req.index_params_json:
            body["index_params"] = _loads(
                req.index_params_json, "index_params_json")
        if req.ranker_json:
            body["ranker"] = _loads(req.ranker_json, "ranker_json")
        if req.load_balance:
            body["load_balance"] = req.load_balance
        if req.sort_json:
            body["sort"] = _loads(req.sort_json, "sort_json",
                                  want=(dict, list, str))
        if req.trace:
            body["trace"] = True
        out = self.router._h_search(body, None)
        resp = self.pb2.SearchResponse(trace_id=out.get("trace_id", ""))
        for per_query in out["documents"]:
            result = resp.results.add()
            for item in per_query:
                rest = {k: v for k, v in item.items()
                        if k not in ("_id", "_score")}
                result.items.add(
                    id=str(item.get("_id", "")),
                    score=float(item.get("_score", 0.0)),
                    fields_json=json.dumps(rest) if rest else "",
                )
        return resp

    def _query(self, req):
        body: dict[str, Any] = {
            "db_name": req.db_name, "space_name": req.space_name,
        }
        if req.document_ids:
            body["document_ids"] = list(req.document_ids)
        if req.filters_json:
            body["filters"] = _loads(req.filters_json, "filters_json")
        if req.HasField("limit"):
            body["limit"] = req.limit
        if req.HasField("offset"):
            body["offset"] = req.offset
        if req.fields:
            body["fields"] = list(req.fields)
        if req.vector_value:
            body["vector_value"] = True
        if req.sort_json:
            body["sort"] = _loads(req.sort_json, "sort_json",
                                  want=(dict, list, str))
        out = self.router._h_query(body, None)
        resp = self.pb2.QueryResponse()
        for doc in out["documents"]:
            rest = {k: v for k, v in doc.items() if k != "_id"}
            resp.documents.add(
                id=str(doc.get("_id", "")),
                fields_json=json.dumps(rest) if rest else "",
            )
        return resp

    def _delete(self, req):
        body: dict[str, Any] = {
            "db_name": req.db_name, "space_name": req.space_name,
        }
        if req.document_ids:
            body["document_ids"] = list(req.document_ids)
        if req.filters_json:
            body["filters"] = _loads(req.filters_json, "filters_json")
        if req.HasField("limit"):
            # limit=0 stays a zero delete budget (deletes nothing),
            # matching the documented HTTP semantics — absent = unbounded
            body["limit"] = req.limit
        out = self.router._h_delete(body, None)
        return self.pb2.DeleteResponse(total=out["total"])
