"""The router's gRPC front end is not ported yet (ROADMAP queue 1 item
9b): the reference's vearch_tpu/cluster/grpc_server.py generates its
stubs with protoc at first use. A port router asked for a gRPC port
(`RouterServer(grpc_port=...)`, `--grpc-port`) raises."""


class GrpcRouter:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the router's gRPC front end is not ported to vearch_tpu_torch "
            "yet: ROADMAP queue 1 item 9b")
