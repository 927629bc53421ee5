"""Cluster metadata entities + metastore key schema.

Mirrors the reference's entity layer (reference: internal/entity/space.go:75
`Space`, partition.go:50 `Partition`, server.go `Server`, meta.go etcd key
schema). Spaces embed the engine TableSchema plus partition topology.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from vearch_tpu_torch.engine.types import TableSchema

# -- metastore key schema (reference: entity/meta.go) ------------------------

PREFIX_DB = "/db/"
PREFIX_SPACE = "/space/"  # /space/{db}/{space}
PREFIX_SERVER = "/server/"  # /server/{node_id}
PREFIX_PARTITION = "/partition/"  # /partition/{id}
SEQ_SPACE_ID = "/seq/space"
SEQ_PARTITION_ID = "/seq/partition"
SEQ_NODE_ID = "/seq/node"


@dataclass
class Partition:
    id: int
    space_id: int
    db_name: str
    space_name: str
    slot: int  # slot range start (reference: entity/partition.go Slot)
    replicas: list[int] = field(default_factory=list)  # node ids
    leader: int = -1  # node id of raft leader
    # raft leadership epoch: bumped by the master on every failover /
    # membership change; fences deposed leaders (raft.py)
    term: int = 1
    # partition-rule group this partition belongs to (the range name;
    # reference: entity/partition.go Partition.Name under PartitionRule)
    group: str | None = None
    # non-voting replication targets (raft learners): they receive
    # appends/snapshots and report lag but never count toward quorum or
    # campaign — the replica-migration catch-up state (reference:
    # etcd-raft learner semantics)
    learners: list[int] = field(default_factory=list)
    # routing-map epoch this partition was minted under; responses echo
    # it so routers detect a split cutover without waiting for the
    # metastore watch
    map_version: int = 0
    # (last_term, last_index) of the leader log chosen at the most
    # recent promotion — the floor a later promotion's candidate must
    # reach, or entries committed under an earlier membership could be
    # discarded (master.py _reconfigure_partition)
    promoted_log: list[int] | None = None

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Partition":
        return cls(**d)


@dataclass
class Space:
    id: int
    name: str
    db_name: str
    schema: TableSchema
    partition_num: int = 1
    replica_num: int = 1
    partitions: list[Partition] = field(default_factory=list)
    # {"type": "RANGE", "field": ..., "ranges": [{"name", "value"}]} —
    # ranges ascending; each range backs partition_num slot-sharded
    # partitions (reference: entity/partition.go:125 PartitionRule)
    partition_rule: dict | None = None
    # replica placement anti-affinity: none|host|rack|zone (reference:
    # config.go:389 strategies 0-3)
    anti_affinity: str = "none"
    # set once partition_num has been expanded online: slots were
    # re-carved, so rows ingested before the expansion may live in a
    # partition that no longer owns their slot — id-routed reads must
    # fan out instead of slot-routing (reference: expandPartitions,
    # space_service.go:792 — same re-carve, same consequence)
    expanded: bool = False
    # partition ids that existed before the latest expansion — the only
    # ones that can hold off-slot rows, so id-routed writes scope their
    # existence probes to these instead of every partition
    pre_expand_pids: list[int] = field(default_factory=list)
    # id->docid cache toggle (reference: entity/space.go:88-94). Kept
    # for wire compat: this engine holds the key->docid map in-process
    # (table.py _key_to_docid — no FFI boundary to cache across), so the
    # cache is structurally always-on; the flag round-trips the API.
    enable_id_cache: bool = True
    # partition-map epoch: bumped by every split cutover; routers
    # compare against response-carried versions to hot-reload the map
    map_version: int = 0
    # declared service objective for this space, e.g.
    # {"latency_ms": 50, "availability": 0.999, "recall_floor": 0.9} —
    # the router scores every logical search against latency/
    # availability and exports error-budget burn rates
    # (docs/ACCOUNTING.md); recall_floor rides the master's register
    # response to every hosting PS, whose shadow recall sampler flags a
    # statistical breach (docs/QUALITY.md). None = unscored
    slo: dict | None = None

    def to_dict(self) -> dict[str, Any]:
        d = {
            "id": self.id,
            "name": self.name,
            "db_name": self.db_name,
            "schema": self.schema.to_dict(),
            "partition_num": self.partition_num,
            "replica_num": self.replica_num,
            "partitions": [p.to_dict() for p in self.partitions],
        }
        if self.partition_rule:
            d["partition_rule"] = self.partition_rule
        if self.anti_affinity != "none":
            d["anti_affinity"] = self.anti_affinity
        if not self.enable_id_cache:
            d["enable_id_cache"] = False
        if self.expanded:
            d["expanded"] = True
        if self.pre_expand_pids:
            d["pre_expand_pids"] = list(self.pre_expand_pids)
        if self.map_version:
            d["map_version"] = self.map_version
        if self.slo:
            d["slo"] = dict(self.slo)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Space":
        return cls(
            id=d["id"],
            name=d["name"],
            db_name=d["db_name"],
            schema=TableSchema.from_dict(d["schema"]),
            partition_num=d.get("partition_num", 1),
            replica_num=d.get("replica_num", 1),
            partitions=[Partition.from_dict(p) for p in d.get("partitions", [])],
            partition_rule=d.get("partition_rule"),
            anti_affinity=d.get("anti_affinity", "none"),
            enable_id_cache=bool(d.get("enable_id_cache", True)),
            expanded=bool(d.get("expanded", False)),
            pre_expand_pids=[int(x) for x in d.get("pre_expand_pids", [])],
            map_version=int(d.get("map_version", 0)),
            slo=d.get("slo"),
        )

    def slot_starts(self) -> list[int]:
        return [p.slot for p in self.partitions]

    # -- partition-rule routing (reference: space.go:198
    #    PartitionIdsByRangeField — first range whose bound exceeds the
    #    field value wins) -------------------------------------------------

    def rule_groups(self) -> dict[str, list[Partition]]:
        groups: dict[str, list[Partition]] = {}
        for p in self.partitions:
            groups.setdefault(p.group or "", []).append(p)
        for parts in groups.values():
            parts.sort(key=lambda p: p.slot)
        return groups

    def rule_bounds(self) -> tuple[list[int], list[str]]:
        """(ascending ns bounds, range names) — normalize the rule once
        per request, not once per document."""
        ranges = self.partition_rule["ranges"]
        return ([rule_value_ns(r["value"]) for r in ranges],
                [r["name"] for r in ranges])

    def rule_group_for(self, value: Any,
                       bounds: tuple[list[int], list[str]] | None = None
                       ) -> str:
        import bisect

        vals, names = bounds if bounds is not None else self.rule_bounds()
        i = bisect.bisect_right(vals, rule_value_ns(value))
        if i >= len(names):
            raise ValueError(
                f"no partition range covers "
                f"{self.partition_rule['field']}={value!r} "
                f"(ranges are exclusive upper bounds)"
            )
        return names[i]


def rule_value_ns(value: Any) -> int:
    """Normalize a partition-rule value to nanoseconds (reference:
    partition.go ToTimestamp — ints are seconds, strings parse as
    dates). Document DATE fields arrive as epoch millis."""
    if isinstance(value, bool):
        raise ValueError("bool is not a date")
    if isinstance(value, (int, float)):
        v = int(value)
        # heuristically scale: ns > 1e16, ms > 1e11, else seconds
        if v > 10**16:
            return v
        if v > 10**11:
            return v * 1_000_000
        return v * 1_000_000_000
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(str(value))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1e9)


@dataclass
class Server:
    node_id: int
    rpc_addr: str  # host:port of the PS data service
    partition_ids: list[int] = field(default_factory=list)
    last_heartbeat: float = field(default_factory=time.time)
    alive: bool = True
    # topology labels for replica anti-affinity (reference:
    # config.go:389 strategies 0-3: none/host/rack/zone)
    labels: dict[str, str] = field(default_factory=dict)
    # load summary riding the PS heartbeat (search queue depth,
    # inflight, latency quantiles): merged into /servers by the master
    # from its in-memory heartbeat state — never persisted, so the
    # metastore is not churned once per heartbeat. Routers score
    # replicas with it for least-loaded read routing.
    load: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Server":
        return cls(**d)
