"""Shared helpers for the framework integrations."""

from __future__ import annotations


def ensure_space(client, db_name: str, space_name: str,
                 fields: list[dict], partition_num: int = 1) -> None:
    """Create the database and space, tolerating only already-exists
    (409); every other failure — bad credentials, unreachable cluster,
    invalid schema — surfaces immediately instead of at first use."""
    from vearch_tpu_torch.cluster.rpc import RpcError

    try:
        client.create_database(db_name)
    except RpcError as e:
        if e.code != 409:
            raise
    try:
        client.create_space(db_name, {
            "name": space_name,
            "partition_num": partition_num,
            "fields": fields,
        })
    except RpcError as e:
        if e.code != 409:
            raise
