"""Master (control plane): metadata CRUD, placement, failure detection.

TPU-native re-design of the reference's master role (reference:
internal/master/cluster_api.go:244 admin routes;
services/space_service.go:59 CreateSpace — schema validate, cluster lock,
slot carving, placement; master_cache.go lease-expiry failure detection).
Route names mirror the reference so SDKs port over directly.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any

from vearch_tpu_torch.cluster import elastic, rpc
from vearch_tpu_torch.cluster.entities import (
    PREFIX_DB,
    PREFIX_SERVER,
    PREFIX_SPACE,
    SEQ_NODE_ID,
    SEQ_PARTITION_ID,
    SEQ_SPACE_ID,
    Partition,
    Server,
    Space,
)
from vearch_tpu_torch.cluster.hashing import carve_slots
from vearch_tpu_torch.cluster.metastore import MetaStore
from vearch_tpu_torch.cluster.rpc import JsonRpcServer, RpcError
from vearch_tpu_torch.engine.types import DataType, ScalarIndexType, TableSchema
from vearch_tpu_torch.utils import log

_log = log.get("master")


def _deepcopy_job(job: dict) -> dict:
    """Stable snapshot of a backup-job record for serving: the worker
    thread mutates the nested dicts while requests read them."""
    out = dict(job)
    out["partitions"] = {k: dict(v) for k, v in job["partitions"].items()}
    out["results"] = list(job["results"])
    return out


def _deepcopy_ejob(job: dict) -> dict:
    """Stable snapshot of an elastic-job record for serving (same
    reason as _deepcopy_job: the worker mutates nested state while
    requests read it)."""
    out = dict(job)
    out["detail"] = dict(job.get("detail") or {})
    out["steps"] = [dict(s) for s in job.get("steps") or []]
    return out

HEARTBEAT_TTL = 8.0


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        persist_path: str | None = None,
        heartbeat_ttl: float = HEARTBEAT_TTL,
        auth: bool = False,
        root_password: str = "secret",
        auto_recover: bool = True,
        recover_delay: float = 5.0,
        node_id: int = 1,
        peers: dict[int, str] | None = None,
        meta_dir: str | None = None,
        election_timeout: float = 1.0,
        meta_log_keep: int = 1000,
        meta_flush_every: int = 500,
        join: str | None = None,
        auto_rebalance: bool = False,
        rebalance_interval: float = 30.0,
    ):
        from vearch_tpu_torch.cluster.auth import AuthService, parse_basic_auth

        self.heartbeat_ttl = heartbeat_ttl
        # meta checkpoint cadence + retained log tail (reference: etcd
        # snapshot-count / compaction knobs); small values in tests
        # force the far-behind-master snapshot path
        self.meta_log_keep = meta_log_keep
        self.meta_flush_every = meta_flush_every
        self.auto_recover = auto_recover
        self.recover_delay = recover_delay
        self.store = MetaStore(persist_path)
        self._stop = threading.Event()
        self._leases: dict[int, int] = {}  # node_id -> lease id
        # serialises every partition reconfiguration (lease-reaper
        # failover, auto-recover loop, /partitions/change_member):
        # two concurrent reconfigs could fence at the same term and
        # appoint two leaders, defeating the fencing safety argument
        self._reconfig_lock = threading.Lock()
        # async backup jobs (reference: backup progress endpoints)
        self._backup_jobs: dict[str, dict] = {}
        self._backup_jobs_lock = threading.Lock()
        # async elastic jobs: online splits, replica migrations, drains,
        # and rebalance applications (each a first-class observable
        # record: GET /cluster/jobs)
        self._elastic_jobs: dict[str, dict] = {}
        self._elastic_jobs_lock = threading.Lock()
        # load-aware auto-rebalance closed loop — default OFF: the
        # planner stays advisory until an operator opts in
        self.auto_rebalance = bool(auto_rebalance)
        self.rebalance_interval = float(rebalance_interval)

        # -- multi-master metadata group (reference: embedded etcd raft,
        # master/server.go:89). peers: {master_node_id: "host:port"}
        # including self; >1 entries = replicated mode with voted
        # elections (cluster/raft.py election mode). Followers proxy
        # non-GET API calls to the current leader and serve reads from
        # their replicated store.
        self.node_id = node_id
        self.peers = dict(peers) if peers else {node_id: ""}
        # `join`: address of any live master of an existing replicated
        # group — this node registers itself via POST /members/add at
        # start() and catches up by log replay or snapshot (reference:
        # etcd member add, cluster_api.go:344-354)
        self.join_addr = join
        self.replicated = len(self.peers) > 1 or join is not None
        self._members_lock = threading.RLock()  # guards the peers map
        # held across a member-change propose: one add/remove at a time
        # (NOT the same lock as _members_lock — the apply path takes
        # that, and apply may run on another thread mid-propose)
        self._member_change_gate = threading.Lock()
        self.meta_node = None
        self._was_leader = not self.replicated
        self.election_timeout = election_timeout
        # a restarted member's peers may have changed since its --peers
        # flag: the replicated membership key is authoritative
        saved = self.store.get("/meta/members")
        if self.replicated and saved:
            self.peers = {int(k): v for k, v in saved.items()}
        if self.replicated:
            assert meta_dir, "multi-master mode needs meta_dir for the WAL"
            # the WAL gets truncated behind checkpoints; without a
            # persisted store snapshot a restart would silently lose
            # everything before the truncation horizon
            assert persist_path, "multi-master mode needs persist_path"
            self.auth_service = AuthService(self.store, root_password,
                                            bootstrap=False)
        else:
            self.auth_service = AuthService(self.store, root_password)
            # a restarted master has persisted /server/ records but
            # empty in-memory leases; grant each a fresh short lease so
            # dead nodes expire through the normal reaper
            self._adopt_server_leases()

        # kept for outbound member RPCs (join below): the target's
        # /members/add is authenticated when auth is on
        self._root_password = root_password

        def authenticator(headers, method, path):
            # per-endpoint privilege enforcement (reference:
            # cluster_api.go:153 role.HasPermissionForResources)
            user, password = parse_basic_auth(headers)
            record = self.auth_service.check(user, password)
            self.auth_service.authorize(record, path, method)

        self._meta_dir = meta_dir
        self.server = JsonRpcServer(
            host,
            port,
            authenticator=authenticator if auth else None,
            # PS registration, internal auth checks, and the metadata
            # raft transport stay open (peer RPCs carry no credentials;
            # reference: /register is in the unauthenticated group and
            # etcd peer traffic is not BasicAuth'd)
            auth_exempt=("/register", "/register_router", "/auth/check",
                         "/", "/master/raft"),
        )
        s = self.server
        s.route("POST", "/auth/check", self._h_auth_check)
        s.route("POST", "/users", self._h_create_user)
        s.route("GET", "/users", self._h_get_user)
        s.route("DELETE", "/users", self._h_delete_user)
        s.route("POST", "/roles", self._h_create_role)
        s.route("GET", "/roles", self._h_get_role)
        s.route("GET", "/", self._h_cluster_info)
        s.route("POST", "/register", self._h_register)
        s.route("POST", "/register_router", self._h_register_router)
        s.route("GET", "/servers", self._h_servers)
        s.route("GET", "/routers", self._h_routers)
        s.route("GET", "/cluster/stats", self._h_cluster_stats)
        s.route("GET", "/cluster/usage", self._h_cluster_usage)
        s.route("GET", "/cluster/health", self._h_cluster_health)
        s.route("GET", "/members", self._h_members)
        s.route("POST", "/members/add", self._h_member_add)
        s.route("POST", "/members/remove", self._h_member_remove)
        s.route("GET", "/schedule/fail_server", self._h_fail_servers)
        s.route("DELETE", "/schedule/fail_server",
                self._h_fail_server_clear)
        s.route("POST", "/schedule/recover_server", self._h_recover_server)
        s.route("GET", "/clean_lock", self._h_clean_lock)
        s.route("PUT", "/users", self._h_update_user)
        s.route("PUT", "/roles", self._h_update_role)
        s.route("GET", "/watch", self._h_watch)
        s.route("POST", "/dbs", self._h_create_db)  # POST /dbs/{db}
        s.route("GET", "/dbs", self._h_get_db)
        s.route("PUT", "/dbs", self._h_update_space)
        s.route("DELETE", "/dbs", self._h_delete_db)
        s.route("GET", "/partitions", self._h_partitions)
        s.route("POST", "/partitions/change_member", self._h_change_member)
        s.route("POST", "/partitions/rule", self._h_partition_rule)
        s.route("POST", "/field_index", self._h_field_index)
        s.route("POST", "/config", self._h_set_config)
        s.route("GET", "/config", self._h_get_config)
        s.route("POST", "/backup/dbs", self._h_backup)
        s.route("GET", "/backup/jobs", self._h_backup_jobs)
        # elastic data plane: online split / migration / drain /
        # rebalance operator verbs + job progress
        s.route("POST", "/partitions/split", self._h_split)
        s.route("POST", "/partitions/migrate", self._h_migrate)
        s.route("POST", "/cluster/rebalance", self._h_rebalance)
        s.route("POST", "/cluster/drain", self._h_drain)
        s.route("GET", "/cluster/plan", self._h_plan)
        s.route("GET", "/cluster/jobs", self._h_elastic_jobs)
        s.route("POST", "/alias", self._h_create_alias)
        # PUT modifies (reference: modifyAlias) — same upsert semantics
        s.route("PUT", "/alias", self._h_create_alias)
        s.route("GET", "/alias", self._h_get_alias)
        s.route("DELETE", "/alias", self._h_delete_alias)

        # -- watch hub (reference: etcd watch streams that the client
        # caches in master_cache.go:414 hang off). Every store mutation
        # bumps a revision and records its key in a small ring; routers
        # long-poll GET /watch?rev=N and invalidate caches the moment
        # metadata changes instead of waiting out a TTL. Watches fire on
        # every master replica in log order, so any master serves them.
        self._watch_rev = 0
        # per-process instance id: revs are process-local counters, so a
        # router failing over between masters (or across a restart) must
        # not compare revs from different epochs by magnitude — it keys a
        # full resync on any epoch change instead
        self._watch_epoch = uuid.uuid4().hex[:12]
        self._watch_ring: list[tuple[int, str]] = []  # (rev, key)
        self._watch_cond = threading.Condition()

        def _on_meta_change(event: str, key: str, _value) -> None:
            if key.startswith("/router/"):
                # ops-only registry: no client caches hang off it, and
                # waking every watcher for each router lease re-grant
                # would reintroduce the churn the guarded heartbeat put
                # avoids
                return
            with self._watch_cond:
                self._watch_rev += 1
                self._watch_ring.append((self._watch_rev, key))
                del self._watch_ring[:-512]
                self._watch_cond.notify_all()

        self.store.watch_prefix("", _on_meta_change)

        # per-node partition stats riding PS heartbeats, in-memory only
        # (a quorum write per 2s heartbeat would be absurd); feeds the
        # cluster gauges below (reference: monitor_service.go:51-73)
        self._node_stats: dict[int, dict[str, dict]] = {}
        # runtime-truth digest riding the same heartbeat: per-node
        # {hbm_drift, drift_bytes, compiles_post_warmup} from the PS
        # device sampler + compile flight recorder
        self._node_obs: dict[int, dict] = {}
        # per-node load summary (search queue depth / inflight /
        # latency quantiles) riding the same heartbeat, merged into
        # /servers so routers can pick the least-loaded replica; also
        # in-memory only — it changes every heartbeat, persisting it
        # would churn the metastore (and fire every watch) at 0.5Hz
        # times the fleet size
        self._node_loads: dict[int, dict] = {}
        # per-tenant usage meters riding the same heartbeat
        # (docs/ACCOUNTING.md): node_id -> {scope_id, spaces, totals,
        # hbm_bytes, _mono}. In-memory like the rest — it changes every
        # heartbeat. The rollup dedups by scope_id: co-located PS nodes
        # share one process accountant and must not double-count.
        self._node_usage: dict[int, dict] = {}
        # previous per-space request counts per scope, for the QPS
        # estimate GET /cluster/usage derives from heartbeat deltas
        self._usage_prev: dict[str, dict] = {}
        # router SLO digests pulled on demand by /cluster/health,
        # memoized a few seconds so health probes stay cheap
        self._router_slo_memo: tuple[float, dict] = (0.0, {})
        self._register_cluster_gauges()

        if self.replicated:
            self._setup_meta_raft()

    def _register_cluster_gauges(self) -> None:
        """Cluster-level /metrics gauges an operator graphs: servers,
        dbs, spaces, partitions, per-space docs/sizes, leaders per node
        (reference: internal/monitor/monitor_service.go:51-77)."""
        m = self.server.metrics

        def count_prefix(prefix: str):
            return lambda: {(): float(len(self.store.prefix(prefix)))}

        m.callback_gauge("vearch_cluster_servers",
                         "registered PS servers", (),
                         count_prefix(PREFIX_SERVER))
        m.callback_gauge("vearch_cluster_fail_servers",
                         "PS servers marked failed", (),
                         count_prefix("/fail_server/"))
        m.callback_gauge("vearch_cluster_dbs", "databases", (),
                         count_prefix(PREFIX_DB))

        # one scrape renders several space-derived gauges; parse the
        # space metadata once per metadata revision instead of once per
        # gauge (any store mutation bumps _watch_rev, so the memo can
        # never serve a stale topology)
        space_memo: dict = {"rev": -1, "spaces": []}

        def _spaces():
            with self._watch_cond:
                rev = self._watch_rev
            if space_memo["rev"] != rev:
                space_memo["spaces"] = [
                    Space.from_dict(d)
                    for d in self.store.prefix(PREFIX_SPACE).values()
                ]
                space_memo["rev"] = rev
            return space_memo["spaces"]

        def spaces_per_db():
            out: dict[tuple, float] = {}
            for s in _spaces():
                out[(s.db_name,)] = out.get((s.db_name,), 0.0) + 1.0
            return out

        m.callback_gauge("vearch_cluster_spaces", "spaces per db",
                         ("db",), spaces_per_db)

        def partitions_per_space():
            return {(s.db_name, s.name): float(len(s.partitions))
                    for s in _spaces()}

        m.callback_gauge("vearch_cluster_partitions",
                         "partitions per space", ("db", "space"),
                         partitions_per_space)

        def leaders_per_node():
            out: dict[tuple, float] = {}
            for s in _spaces():
                for p in s.partitions:
                    if p.leader >= 0:
                        key = (str(p.leader),)
                        out[key] = out.get(key, 0.0) + 1.0
            return out

        m.callback_gauge("vearch_cluster_partition_leaders",
                         "partitions led per PS node", ("node_id",),
                         leaders_per_node)

        def _space_stat(field: str):
            def fn():
                out: dict[tuple, float] = {}
                for s in _spaces():
                    total = 0.0
                    for p in s.partitions:
                        # leader replica's report is authoritative; a
                        # mid-failover gap falls back to the largest
                        # replica report rather than dropping to zero
                        best = None
                        leader = self._node_stats.get(p.leader, {})
                        st = leader.get(str(p.id))
                        if st is not None:
                            best = float(st.get(field, 0))
                        else:
                            for nid in p.replicas:
                                st = self._node_stats.get(nid, {}).get(
                                    str(p.id))
                                if st is not None:
                                    v = float(st.get(field, 0))
                                    best = v if best is None else max(
                                        best, v)
                        total += best or 0.0
                    out[(s.db_name, s.name)] = total
                return out
            return fn

        m.callback_gauge("vearch_space_docs", "docs per space",
                         ("db", "space"), _space_stat("doc_count"))
        m.callback_gauge("vearch_space_size_bytes",
                         "engine bytes per space", ("db", "space"),
                         _space_stat("size_bytes"))

        def imbalance():
            loads = elastic.node_loads(self._alive_servers(),
                                       self._node_stats)
            return {(): elastic.imbalance_score(loads.values())}

        m.callback_gauge("vearch_cluster_imbalance_score",
                         "(max-min)/mean of per-PS engine bytes",
                         (), imbalance)

        def elastic_running():
            with self._elastic_jobs_lock:
                n = sum(1 for j in self._elastic_jobs.values()
                        if j["status"] == "running")
            return {(): float(n)}

        m.callback_gauge("vearch_elastic_jobs_running",
                         "elastic jobs (split/migrate/drain/rebalance) "
                         "in flight", (), elastic_running)

        # outcome counters pre-seed both label values so dashboards see
        # the full series set from the first scrape
        self._m_splits = m.counter(
            "vearch_partition_splits_total",
            "completed partition-split jobs by outcome", ("status",))
        self._m_migrations = m.counter(
            "vearch_replica_migrations_total",
            "completed replica-migration jobs by outcome", ("status",))
        for st in ("done", "error"):
            self._m_splits.inc(st, by=0.0)
            self._m_migrations.inc(st, by=0.0)

    # -- multi-master plumbing ----------------------------------------------

    def _setup_meta_raft(self) -> None:
        import os as _os

        from vearch_tpu_torch.cluster.raft import RaftNode

        store = self.store

        def apply(op):
            # applied-index rides in the same persisted json as the kv
            # state, so recovery replays exactly the unapplied tail
            # (next_id is not idempotent — double-replay would skew ids)
            store.applied_index = self.meta_node.applied + 1
            if (op.get("t") or op.get("type")) == "member_change":
                return self._apply_member_change(op)
            return store.apply_op(op)

        def send(peer: int, path: str, body: dict) -> dict:
            # short timeout: a campaign sends votes sequentially — a
            # slow peer must not stall the candidate past every other
            # node's election timer
            return rpc.call(self.peers[peer], "POST", path, body,
                            timeout=3.0)

        def snapshot():
            node = self.meta_node
            with node._apply_lock:
                store.applied_index = node.applied
                return store.snapshot_bytes(), node.applied

        self.meta_node = RaftNode(
            pid=0, node_id=self.node_id,
            wal_dir=_os.path.join(self._meta_dir, "meta_raft"),
            apply_fn=apply, send_fn=send,
            members=sorted(self.peers),
            is_leader=False,
            snapshot_fn=snapshot,
            install_fn=lambda data, idx: self._install_meta_snapshot(data),
            quorum_timeout=5.0,
            election_timeout=self.election_timeout,
            route_prefix="/master/raft",
        )
        self.meta_node.applied = store.applied_index
        self.meta_node.recover_singleton_commit()
        self.meta_node._apply_to_commit()
        store.proposer = lambda op: self.meta_node.propose([op])[0]

        s = self.server
        s.route("POST", "/master/raft/append",
                lambda b, p: self.meta_node.handle_append(b))
        s.route("POST", "/master/raft/vote",
                lambda b, p: self.meta_node.handle_vote(b))
        s.route("POST", "/master/raft/snapshot",
                lambda b, p: self.meta_node.handle_install_snapshot(b))
        s.route("GET", "/master/raft/state",
                lambda b, p: self.meta_node.state())
        self.server.middleware = self._leader_proxy

    def _leader_proxy(self, method, path, body, headers):
        """Follower middleware: metadata raft RPCs and reads serve
        locally (replicated store; etcd-style serializable reads);
        everything else forwards to the current leader."""
        if not self.replicated or self.is_leader:
            return None
        if path.startswith("/master/raft") or method == "GET":
            return None
        if headers.get("X-Vearch-Forwarded"):
            raise RpcError(503, "no metadata leader (forward loop)")
        hint = self.meta_node.leader_hint
        if hint is None or hint == self.node_id or hint not in self.peers:
            raise RpcError(503, "no metadata leader known yet")
        fwd = {"X-Vearch-Forwarded": "1"}
        # the client's credentials must travel with the request or the
        # leader's authenticator rejects every proxied mutation
        if headers.get("Authorization"):
            fwd["Authorization"] = headers["Authorization"]
        return rpc.call(self.peers[hint], method, path, body,
                        extra_headers=fwd)

    @property
    def is_leader(self) -> bool:
        return self.meta_node.is_leader if self.replicated else True

    def _adopt_server_leases(self) -> None:
        for key, val in self.store.prefix(PREFIX_SERVER).items():
            nid = int(key[len(PREFIX_SERVER):])
            old = self._leases.get(nid)
            if old is not None:
                # a stale lease from a previous leadership would expire
                # later and delete the key the fresh lease now owns
                self.store.revoke_lease(old)
            lease = self.store.grant_lease(self.heartbeat_ttl)
            self._leases[nid] = lease
            self.store.put(key, val, lease=lease)
        # router registry entries age out the same way: without a fresh
        # lease on the NEW leader, a router that died across the
        # promotion would be listed forever
        leases = getattr(self, "_router_leases", None)
        if leases is None:
            leases = self._router_leases = {}
        for key, val in self.store.prefix("/router/").items():
            addr = key[len("/router/"):]
            old = leases.get(addr)
            if old is not None:
                self.store.revoke_lease(old)
            lease = self.store.grant_lease(60.0)
            leases[addr] = lease
            self.store.put(key, val, lease=lease)

    def _election_loop(self) -> None:
        keep = self.meta_log_keep  # log tail kept behind meta snapshots
        last_flush = 0
        while not self._stop.is_set():
            time.sleep(max(0.05, self.election_timeout / 4))
            try:
                self.meta_node.election_tick()
                if self.meta_node.is_leader:
                    # leader heartbeat: resets follower election timers
                    # and pushes the commit index
                    self.meta_node.tick()
                leader_now = self.meta_node.is_leader
                if leader_now and not self._was_leader:
                    # promotion work proposes log entries (quorum waits)
                    # — run it off-thread so heartbeats keep flowing, and
                    # retry while leadership holds
                    threading.Thread(target=self._on_promoted,
                                     daemon=True,
                                     name="master-promote").start()
                self._was_leader = leader_now
                # periodic meta checkpoint + log truncation
                node = self.meta_node
                if node.applied - last_flush >= self.meta_flush_every:
                    with node._apply_lock:
                        self.store.applied_index = node.applied
                        self.store._persist()
                        last_flush = node.applied
                    node.wal.save_meta(fsync=True)
                    node.wal.truncate_prefix(
                        max(node.wal.first_index, node.applied - keep + 1)
                    )
            except Exception as e:
                _log.error("master %s: election tick failed: %s: %s",
                           self.node_id, type(e).__name__, e)

    def _on_promoted(self) -> None:
        """Leadership acquisition: bootstrap auth records and re-lease
        persisted servers. Retries while we stay leader — each op is a
        quorum write that can transiently fail during churn."""
        for _ in range(40):
            if self._stop.is_set() or not self.is_leader:
                return
            try:
                self.auth_service.ensure_bootstrap()
                self._adopt_server_leases()
                return
            except (RpcError, ValueError) as e:
                # ValueError: wal closed by a concurrent stop()
                _log.warning("master %s: promotion work retrying: %s",
                             self.node_id, str(e)[:60])
                time.sleep(0.3)

    def _h_watch(self, body, _parts) -> dict:
        """Long-poll watch (reference: etcd Watch streams): blocks until
        the metadata revision passes the caller's `rev` or `timeout`
        elapses; returns the new revision plus the changed keys since
        `rev` (empty on timeout, `reset` when the caller is older than
        the 512-event ring — resync by full cache invalidation)."""
        body = body or {}
        rev = int(body.get("rev", 0))
        timeout = min(float(body.get("timeout", 25.0)), 55.0)
        with self._watch_cond:
            if rev > self._watch_rev:
                # the caller is AHEAD of this process (master restarted
                # or failed over — revs are per-process): make it resync
                # now, not after a full idle poll window during which
                # invalidations would be silently lost
                return {"rev": self._watch_rev, "epoch": self._watch_epoch,
                        "reset": True, "keys": []}
        deadline = time.monotonic() + timeout
        with self._watch_cond:
            while self._watch_rev <= rev and not self._stop.is_set():
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._watch_cond.wait(min(remain, 1.0))
            cur = self._watch_rev
            ring = list(self._watch_ring)
        if cur <= rev:
            return {"rev": cur, "epoch": self._watch_epoch, "keys": []}
        oldest = ring[0][0] if ring else cur + 1
        if rev + 1 < oldest:
            # the caller missed events beyond the ring: tell it to drop
            # everything rather than serve a partial delta as complete
            return {"rev": cur, "epoch": self._watch_epoch,
                    "reset": True, "keys": []}
        return {
            "rev": cur,
            "epoch": self._watch_epoch,
            "keys": sorted({k for r, k in ring if r > rev}),
        }

    def start(self) -> None:
        self.server.start()
        threading.Thread(target=self._lease_reaper, daemon=True,
                         name="master-lease-reaper").start()
        if self.auto_recover:
            threading.Thread(target=self._auto_recover_loop,
                             daemon=True, name="master-auto-recover").start()
        if self.auto_rebalance:
            threading.Thread(target=self._auto_rebalance_loop,
                             daemon=True, name="master-rebalance").start()
        if self.join_addr and len(self.peers) <= 1:
            # register with the existing group (any member forwards the
            # POST to the leader); the response carries the full member
            # map, and the leader starts replicating to us — catch-up
            # is ordinary log replay or a snapshot install
            from vearch_tpu_torch.cluster.auth import ROOT_NAME

            # /members/add is NOT auth-exempt: joining an auth-enabled
            # group without credentials dies with an unhandled 401
            out = rpc.call(self.join_addr, "POST", "/members/add",
                           {"node_id": self.node_id, "addr": self.addr},
                           timeout=30.0,
                           auth=(ROOT_NAME, self._root_password))
            with self._members_lock:
                self.peers = {int(k): v for k, v in out["members"].items()}
                with self.meta_node._lock:
                    self.meta_node.members = sorted(self.peers)
        if self.replicated:
            threading.Thread(target=self._election_loop,
                             daemon=True, name="master-election").start()

    def stop(self) -> None:
        self._stop.set()
        if self.meta_node is not None:
            self.meta_node.close()
        self.server.stop()

    @property
    def addr(self) -> str:
        return self.server.addr

    # -- failure detection (reference: master_cache.go:963-1005) -------------

    def _lease_reaper(self) -> None:
        tick = min(1.0, self.heartbeat_ttl / 4)
        while not self._stop.is_set():
            time.sleep(tick)
            if not self.is_leader:
                continue  # leases are leader state
            try:
                for key in self.store.expire_leases():
                    if key.startswith(PREFIX_SERVER):
                        # durable FailServer record (reference:
                        # master_cache.go:963-1005) + immediate failover
                        node_id = int(key[len(PREFIX_SERVER):])
                        self.store.put(f"/fail_server/{node_id}", {
                            "node_id": node_id, "time": time.time(),  # lint: allow[wall-clock] durable failure stamp read across master restarts
                        })
                        # drop its last heartbeat stats: serving a dead
                        # node's doc/size report as current (via the
                        # replica-fallback in the space gauges) would
                        # show stale numbers for the process lifetime
                        self._node_stats.pop(node_id, None)
                        self._node_obs.pop(node_id, None)
                        self._node_loads.pop(node_id, None)
                        self._failover_node(node_id)
            except Exception as e:
                # store mutations propose through the meta log and can
                # transiently 421/503 during leadership churn — the
                # failure-detection thread must survive that
                _log.error("master %s: lease reap failed: %s: %s",
                           self.node_id, type(e).__name__, e)

    def _failover_node(self, dead_node: int) -> None:
        """Reconfigure every partition hosted on the dead node: fence all
        reachable replicas with a bumped term, promote the one with the
        max (last_term, last_index) log, and remove the dead node from
        the membership so quorum is computable again (reference:
        raft election + ChangeMember, services/server_service.go:95).

        Safety: promotion requires that the alive replicas intersect
        every possible commit quorum of the old membership — i.e. at
        least n - quorum(n) + 1 of n replicas reachable. The max-log
        replica among such a set holds every entry committed UNDER THE
        CURRENT membership. Entries committed under an earlier
        membership are only guaranteed in the log of the leader chosen
        at the previous reconfiguration, so each promotion also records
        that leader's (last_term, last_index) as `promoted_log` and a
        later promotion refuses any candidate behind it (see
        _reconfigure_partition). Below either threshold the partition
        stays unavailable (leaderless) rather than silently dropping
        acked data."""
        servers = {s.node_id: s for s in self._alive_servers()}
        with self._reconfig_lock:
            for key, sp in self.store.prefix(PREFIX_SPACE).items():
                changed = False
                for p in sp["partitions"]:
                    if dead_node not in p["replicas"]:
                        continue
                    if self._reconfigure_partition(p, servers,
                                                   drop=dead_node):
                        changed = True
                if changed:
                    self.store.put(key, sp)

    def _reconfigure_partition(self, p: dict, servers: dict,
                               drop: int | None = None) -> bool:
        """Fence alive replicas, pick the best leader, decree the new
        membership. Mutates the partition dict in place; returns whether
        anything changed."""
        replicas = list(p["replicas"])
        n = len(replicas)
        quorum = n // 2 + 1
        new_term = int(p.get("term", 1)) + 1
        states = {}
        for r in replicas:
            srv = servers.get(r)
            if srv is None or (drop is not None and r == drop):
                continue
            try:
                states[r] = rpc.call(srv.rpc_addr, "POST", "/ps/raft/fence",
                                     {"pid": p["id"], "term": new_term})
            except RpcError:
                continue
        # commit-quorum intersection bound (see _failover_node docstring)
        if len(states) < n - quorum + 1 or not states:
            return False
        best = max(
            states,
            key=lambda r: (states[r]["last_term"], states[r]["last_index"]),
        )
        best_log = (int(states[best]["last_term"]),
                    int(states[best]["last_index"]))
        # chained-reconfiguration floor: the intersection bound above
        # only covers entries committed under the CURRENT membership.
        # Entries committed under an earlier membership can live solely
        # in the log of the leader promoted at the previous reconfigure
        # until its peers catch up — fencing a set that excludes that
        # leader while a survivor still lags would promote a stale log
        # and discard acked writes. Refuse until some candidate reaches
        # the recorded watermark; WALs are durable, so the floor becomes
        # satisfiable again when the log-holder returns.
        floor = p.get("promoted_log")
        if floor is not None and best_log < (int(floor[0]), int(floor[1])):
            return False
        members = sorted(states)
        p["leader"] = best
        p["term"] = new_term
        p["replicas"] = members
        p["promoted_log"] = list(best_log)
        try:
            rpc.call(servers[best].rpc_addr, "POST", "/ps/raft/lead",
                     {"pid": p["id"], "term": new_term, "members": members})
        except RpcError:
            return False
        for r in members:
            if r == best:
                continue
            try:
                rpc.call(servers[r].rpc_addr, "POST", "/ps/raft/members",
                         {"pid": p["id"], "term": new_term,
                          "members": members, "leader": best})
            except RpcError:
                pass
        return True

    # -- auto-recover: re-place lost replicas (reference: AutoRecoverPs
    #    loop, client/master_cache.go:1154; ChangeMember to a healthy PS
    #    after replica_auto_recover_time) -----------------------------------

    def _auto_recover_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(1.0)
            if not self.is_leader:
                continue
            try:
                with self._reconfig_lock:
                    self._auto_recover_once()
            except Exception as e:
                _log.error("auto-recover pass failed: %s: %s",
                           type(e).__name__, e)

    def _auto_recover_once(self) -> None:
        servers = {s.node_id: s for s in self._alive_servers()}
        if not servers:
            return
        # replica re-placement only counts after the failure has aged
        # past recover_delay (a restarting node should rejoin, not be
        # rebuilt); leaderless reconciliation below runs regardless
        fails = self.store.prefix("/fail_server/")
        may_replace = not any(
            time.time() - v["time"] < self.recover_delay  # lint: allow[wall-clock] compares against the durable fail stamp, same clock
            for v in fails.values()
        )
        for key, sp in self.store.prefix(PREFIX_SPACE).items():
            replica_num = int(sp.get("replica_num", 1))
            changed = False
            for p in sp["partitions"]:
                # leaderless reconciliation: lease expiry fires failover
                # once; if promotion was unsafe then (too few alive
                # replicas to cover the commit quorum), retry here as
                # nodes return
                if p["leader"] not in servers and any(
                    r in servers for r in p["replicas"]
                ):
                    if self._reconfigure_partition(p, servers,
                                                   drop=p["leader"]):
                        changed = True
            for p in sp["partitions"]:
                if len(p["replicas"]) >= replica_num:
                    continue
                if p["leader"] not in servers:
                    continue  # no live leader to copy from
                candidates = [
                    s for nid, s in servers.items()
                    if nid not in p["replicas"]
                ]
                if not candidates:
                    continue
                # a RETURNING replica (the partition is already on its
                # disk) rejoins immediately — recover_delay exists to
                # avoid rebuilding data onto fresh nodes mid-restart,
                # not to keep a restarted member out of its own group
                returning = [s for s in candidates
                             if p["id"] in s.partition_ids]
                if returning:
                    target = returning[0]
                elif may_replace:
                    # least-loaded placement (reference: anti-affinity
                    # by node; fewest partitions wins)
                    target = min(candidates,
                                 key=lambda s: len(s.partition_ids))
                else:
                    continue
                if self._add_replica(sp, p, target, servers):
                    changed = True
            if changed:
                self.store.put(key, sp)

    def _add_replica(self, sp: dict, p: dict, target, servers) -> bool:
        """Create the partition on `target` as a follower and decree the
        widened membership; the leader's next tick catches it up by log
        replay or snapshot (reference: recover via raft snapshot)."""
        new_term = int(p.get("term", 1)) + 1
        members = sorted(set(p["replicas"]) | {target.node_id})
        part = dict(p)
        part["replicas"] = members
        part["term"] = new_term
        try:
            rpc.call(target.rpc_addr, "POST", "/ps/partition/create", {
                "partition": part,
                "schema": sp["schema"],
            })
        except RpcError as e:
            if e.code != 409:  # already hosted: continue with membership
                return False
        p["replicas"] = members
        p["term"] = new_term
        ok = True
        for r in members:
            srv = servers.get(r)
            if srv is None:
                continue
            path = "/ps/raft/lead" if r == p["leader"] else "/ps/raft/members"
            try:
                rpc.call(srv.rpc_addr, "POST", path,
                         {"pid": p["id"], "term": new_term,
                          "members": members, "leader": p["leader"]})
            except RpcError:
                ok = ok and r != p["leader"]
        if p["id"] not in target.partition_ids:
            target.partition_ids.append(p["id"])
            self.store.put(f"{PREFIX_SERVER}{target.node_id}",
                           target.to_dict())
        return ok

    def _h_change_member(self, body: dict, _parts) -> dict:
        """Manual membership admin (reference: /partitions/change_member,
        cluster_api.go:309-319; method 0=add, 1=remove)."""
        pid = int(body["partition_id"])
        node_id = int(body["node_id"])
        method = body.get("method", "add")
        servers = {s.node_id: s for s in self._alive_servers()}
        with self._reconfig_lock:
            return self._change_member_locked(pid, node_id, method, servers)

    def _change_member_locked(self, pid, node_id, method, servers) -> dict:
        for key, sp in self.store.prefix(PREFIX_SPACE).items():
            for p in sp["partitions"]:
                if p["id"] != pid:
                    continue
                if method in ("add", 0):
                    srv = servers.get(node_id)
                    if srv is None:
                        raise RpcError(404, f"node {node_id} not alive")
                    if not self._add_replica(sp, p, srv, servers):
                        raise RpcError(503, "add_member failed")
                else:
                    if node_id not in p["replicas"]:
                        raise RpcError(404,
                                       f"node {node_id} not a replica")
                    if not self._reconfigure_partition(p, servers,
                                                       drop=node_id):
                        raise RpcError(503, "remove_member failed")
                    srv = servers.get(node_id)
                    if srv is not None:
                        try:
                            rpc.call(srv.rpc_addr, "POST",
                                     "/ps/partition/delete",
                                     {"partition_id": pid})
                        except RpcError:
                            pass
                self.store.put(key, sp)
                return {"partition": p}
        raise RpcError(404, f"partition {pid} not found")

    # -- users / roles (reference: cluster_api.go user/role admin) -----------

    def _h_auth_check(self, body: dict, _parts) -> dict:
        return self.auth_service.check(body["name"], body["password"])

    def _h_create_user(self, body: dict, _parts) -> dict:
        return self.auth_service.create_user(
            body["name"], body["password"], body.get("role", "read")
        )

    def _h_get_user(self, _body, parts) -> dict:
        if parts:
            u = self.store.get(f"/user/{parts[0]}")
            if u is None:
                raise RpcError(404, f"user {parts[0]} not found")
            return {"name": u["name"], "role": u["role"]}
        return {"users": [
            {"name": u["name"], "role": u["role"]}
            for u in self.store.prefix("/user/").values()
        ]}

    def _h_delete_user(self, _body, parts) -> dict:
        if not parts:
            raise RpcError(404, "DELETE /users/{name}")
        self.auth_service.delete_user(parts[0])
        return {"name": parts[0]}

    def _h_create_role(self, body: dict, _parts) -> dict:
        return self.auth_service.create_role(
            body["name"], body.get("privileges", {})
        )

    def _h_get_role(self, _body, parts) -> dict:
        if parts:
            r = self.store.get(f"/role/{parts[0]}")
            if r is None:
                raise RpcError(404, f"role {parts[0]} not found")
            return r
        return {"roles": list(self.store.prefix("/role/").values())}

    def _h_update_user(self, body: dict, _parts) -> dict:
        """PUT /users — change a user's password and/or role
        (reference: cluster_api.go updateUser)."""
        return self.auth_service.update_user(
            body["name"], password=body.get("password"),
            role=body.get("role"),
        )

    def _h_update_role(self, body: dict, _parts) -> dict:
        """PUT /roles — replace a role's privilege map (reference:
        cluster_api.go changeRolePrivilege)."""
        return self.auth_service.update_role(
            body["name"], body.get("privileges", {})
        )

    # -- router registry (reference: register_router + GET /routers —
    #    lease-backed like PS registration, so ops can see the router
    #    fleet and dead routers age out) --------------------------------------

    def _h_register_router(self, body: dict, _parts) -> dict:
        addr = str(body["addr"])
        key = f"/router/{addr}"
        leases = getattr(self, "_router_leases", None)
        if leases is None:
            leases = self._router_leases = {}
        lease = leases.get(addr)
        ttl = 60.0  # routers re-register per watch-poll (<=20s cadence)
        if lease is None or not self.store.keepalive(lease, ttl):
            lease = self.store.grant_lease(ttl)
            leases[addr] = lease
            self.store.put(key, {"addr": addr, "register_time": time.time()},  # lint: allow[wall-clock] operator-facing registration stamp
                           lease=lease)
        return {"addr": addr}

    def _h_routers(self, _body, _parts) -> dict:
        return {"routers": list(self.store.prefix("/router/").values())}

    # -- cluster ops views (reference: /cluster/stats, /cluster/health,
    #    /members, /schedule/*, /clean_lock) ---------------------------------

    def _leader_get(self, path: str):
        """Forward a GET to the current meta leader when heartbeat-fed
        in-memory state is needed (heartbeats land on the leader only;
        followers would serve empty views). Returns None when THIS node
        leads (caller serves locally)."""
        if not self.replicated or self.is_leader:
            return None
        hint = self.meta_node.leader_hint
        if hint is None or hint == self.node_id or hint not in self.peers:
            raise RpcError(503, "no metadata leader known yet")
        # the caller's credentials must ride along (as _leader_proxy
        # does) or the leader's authenticator 401s the forwarded GET
        auth_hdr = rpc.current_auth_header()
        extra = {"Authorization": auth_hdr} if auth_hdr else None
        return rpc.call(self.peers[hint], "GET", path, extra_headers=extra)

    def _h_cluster_stats(self, _body, _parts) -> dict:
        """Per-node partition stats as last heartbeated (reference:
        cluster_api.go stats)."""
        fwd = self._leader_get("/cluster/stats")
        if fwd is not None:
            return fwd
        servers = {s.node_id: s for s in self._alive_servers()}
        return {"stats": [
            {"node_id": nid, "rpc_addr": srv.rpc_addr,
             "partitions": dict(self._node_stats.get(nid, {}))}
            for nid, srv in sorted(servers.items())
        ]}

    def _h_cluster_usage(self, _body, _parts) -> dict:
        """Cluster-wide per-tenant usage rollup (docs/ACCOUNTING.md):
        the heartbeat-fed per-node accountant snapshots summed by
        space, deduplicated by accountant scope (co-located PS nodes in
        one process share one accountant — billing each scope once
        keeps the rollup conservation-exact), plus a QPS estimate from
        consecutive heartbeat deltas and the top consumers by
        device time."""
        from vearch_tpu_torch.obs import accounting

        fwd = self._leader_get("/cluster/usage")
        if fwd is not None:
            return fwd
        servers = {s.node_id: s for s in self._alive_servers()}
        spaces: dict[str, dict] = {}
        totals = {m: 0 for m in accounting.METERS}
        hbm: dict[str, int] = {}
        qps: dict[str, float] = {}
        seen_scopes: list[str] = []
        for nid in sorted(servers):
            u = self._node_usage.get(nid)
            if not u:
                continue
            # HBM residency is per-NODE (each PS models its own hosted
            # engines), so it sums across every reporter even when the
            # meter scope is shared
            for sp, n in (u.get("hbm_bytes") or {}).items():
                hbm[sp] = hbm.get(sp, 0) + int(n)
            scope = str(u.get("scope_id") or f"node-{nid}")
            if scope in seen_scopes:
                continue
            seen_scopes.append(scope)
            for sp, meters in (u.get("spaces") or {}).items():
                acc = spaces.setdefault(
                    sp, {m: 0 for m in accounting.METERS})
                for mname, v in meters.items():
                    if mname in acc:
                        acc[mname] += int(v)
            for mname, v in (u.get("totals") or {}).items():
                if mname in totals:
                    totals[mname] += int(v)
            # QPS from consecutive heartbeat deltas of the requests
            # meter, per scope (monotonic stamps; a re-sent snapshot
            # contributes zero, never a negative rate)
            mono = float(u.get("_mono") or 0.0)
            prev = self._usage_prev.get(scope)
            if prev is not None and mono > prev["mono"]:
                dt = mono - prev["mono"]
                for sp, meters in (u.get("spaces") or {}).items():
                    d = int(meters.get("requests", 0)) - int(
                        prev["req"].get(sp, 0))
                    if d > 0:
                        qps[sp] = qps.get(sp, 0.0) + d / dt
            if prev is None or mono > prev["mono"]:
                self._usage_prev[scope] = {
                    "mono": mono,
                    "req": {sp: int(m.get("requests", 0))
                            for sp, m in (u.get("spaces") or {}).items()},
                }
        ranked = sorted(spaces.items(),
                        key=lambda kv: kv[1]["device_us"], reverse=True)
        return {
            "spaces": {
                sp: {**m,
                     "device_ms": round(m["device_us"] / 1e3, 3),
                     "qps": round(qps.get(sp, 0.0), 2),
                     "hbm_bytes": hbm.get(sp, 0)}
                for sp, m in spaces.items()
            },
            "totals": {**totals,
                       "device_ms": round(totals["device_us"] / 1e3, 3)},
            "top_consumers": [
                {"space": sp,
                 "device_ms": round(m["device_us"] / 1e3, 3),
                 "dispatches": m["dispatches"],
                 "h2d_bytes": m["h2d_bytes"],
                 "requests": m["requests"],
                 "qps": round(qps.get(sp, 0.0), 2)}
                for sp, m in ranked[:10]
            ],
            "scopes": seen_scopes,
        }

    def _router_slo_digest(self) -> dict[str, dict]:
        """Merged per-space SLO burn state pulled from every registered
        router's /router/stats, memoized a few seconds so health probes
        stay cheap. Per space, the WORST burn across routers wins (each
        router only sees its own share of the traffic). Unreachable
        routers are skipped — health degradation must not depend on
        every router answering."""
        now = time.monotonic()
        ts, memo = self._router_slo_memo
        if now - ts < 5.0:
            return memo
        merged: dict[str, dict] = {}
        for rec in list(self.store.prefix("/router/").values()):
            addr = rec.get("addr")
            if not addr:
                continue
            try:
                stats = rpc.call(addr, "GET", "/router/stats",
                                 timeout=2.0)
            except RpcError:
                continue
            for space, s in (stats.get("slo") or {}).items():
                cur = merged.setdefault(space, {
                    "burn_fast": 0.0, "burn_slow": 0.0,
                    "fast_burn": False, "samples": 0,
                    "objective": s.get("objective"),
                })
                cur["burn_fast"] = max(cur["burn_fast"],
                                       float(s.get("burn_fast") or 0.0))
                cur["burn_slow"] = max(cur["burn_slow"],
                                       float(s.get("burn_slow") or 0.0))
                cur["fast_burn"] = bool(cur["fast_burn"]
                                        or s.get("fast_burn"))
                cur["samples"] += int(s.get("samples") or 0)
        self._router_slo_memo = (now, merged)
        return merged

    def _h_cluster_health(self, _body, _parts) -> dict:
        """Per-space health roll-up (reference: cluster_api.go health):
        green = every partition leader-alive and fully replicated,
        yellow = serving but under-replicated, red = leaderless.

        Also rolls up index-build job state from the heartbeat-fed
        partition stats: partitions with a build in flight (or whose
        last build failed) are annotated, and cluster-level
        builds_running / builds_failed counts surface stuck or broken
        background jobs without scraping every PS."""
        fwd = self._leader_get("/cluster/health")
        if fwd is not None:
            return fwd
        servers = {s.node_id for s in self._alive_servers()}
        # partition id -> build status, as last heartbeated by any node
        # hosting it (leader wins when both report)
        builds: dict[int, str] = {}
        splits: dict[int, str] = {}
        for nid, parts_stats in list(self._node_stats.items()):
            for pid_s, st in dict(parts_stats).items():
                bs = st.get("build_status")
                if bs and (st.get("leader") or int(pid_s) not in builds):
                    builds[int(pid_s)] = bs
                ss = st.get("split_status")
                if ss and (st.get("leader") or int(pid_s) not in splits):
                    splits[int(pid_s)] = ss
        builds_running = builds_failed = 0
        # elastic rollup: PS-side split jobs ride heartbeats; master-side
        # job records (splits, migrations, drains, rebalances) live here
        splits_running = sum(1 for v in splits.values() if v == "running")
        splits_failed = sum(1 for v in splits.values() if v == "error")
        with self._elastic_jobs_lock:
            el_running = sum(1 for j in self._elastic_jobs.values()
                             if j["status"] == "running")
            el_failed = sum(1 for j in self._elastic_jobs.values()
                            if j["status"] == "error")
            migrations_running = sum(
                1 for j in self._elastic_jobs.values()
                if j["status"] == "running"
                and j["op"] in ("migrate", "drain", "rebalance"))
        spaces = []
        worst = "green"
        rank = {"green": 0, "yellow": 1, "red": 2}
        for sp in self.store.prefix(PREFIX_SPACE).values():
            status = "green"
            parts = []
            for p in sp.get("partitions", []):
                alive = [r for r in p["replicas"] if r in servers]
                if p["leader"] not in servers:
                    pstat = "red"
                elif len(alive) < int(sp.get("replica_num", 1)):
                    pstat = "yellow"
                else:
                    pstat = "green"
                entry = {"id": p["id"], "status": pstat,
                         "alive_replicas": len(alive)}
                ss = splits.get(int(p["id"]))
                if ss:
                    entry["split"] = ss
                bs = builds.get(int(p["id"]))
                if bs:
                    entry["build"] = bs
                    if bs == "running":
                        builds_running += 1
                    elif bs == "error":
                        builds_failed += 1
                parts.append(entry)
                if rank[pstat] > rank[status]:
                    status = pstat
            spaces.append({"db_name": sp["db_name"], "name": sp["name"],
                           "status": status, "partitions": parts})
            if rank[status] > rank[worst]:
                worst = status
        status = worst if spaces else "green"
        # runtime-truth degradation: a node whose measured HBM has
        # drifted off the footprint model is still serving, but its
        # capacity math (rebalance placement, admission) is built on a
        # model that is now provably wrong — that is a yellow cluster
        # even when every partition is fully replicated
        drift_nodes = sorted(
            nid for nid, obs in list(self._node_obs.items())
            if obs.get("hbm_drift")
        )
        if drift_nodes and rank[status] < rank["yellow"]:
            status = "yellow"
        # SLO degradation: a space burning its declared error budget at
        # page rate (router-scored fast window) is a tenant-visible
        # incident even while every partition is green-replicated
        slo = self._router_slo_digest()
        slo_burn_spaces = sorted(
            sp for sp, rec in slo.items() if rec.get("fast_burn"))
        if slo_burn_spaces and rank[status] < rank["yellow"]:
            status = "yellow"
        # quality degradation: a space whose shadow-sampled recall sits
        # statistically under its declared floor is serving wrong
        # answers with green replication — that is a tenant-visible
        # incident exactly like an SLO burn (docs/QUALITY.md)
        recall_breach_spaces = sorted({
            s for obs in list(self._node_obs.values())
            for s in (obs.get("recall_breach_spaces") or [])
        })
        if recall_breach_spaces and rank[status] < rank["yellow"]:
            status = "yellow"
        needs_retrain = sorted({
            int(p) for obs in list(self._node_obs.values())
            for p in (obs.get("needs_retrain_pids") or [])
        })
        return {"status": status, "spaces": spaces,
                "recall_breach_spaces": recall_breach_spaces,
                "needs_retrain_partitions": needs_retrain,
                "slo_fast_burn_spaces": slo_burn_spaces,
                "hbm_drift_nodes": drift_nodes,
                "serving_compiles": sum(
                    int(obs.get("compiles_post_warmup") or 0)
                    for obs in list(self._node_obs.values())
                ),
                "builds_running": builds_running,
                "builds_failed": builds_failed,
                "splits_running": splits_running,
                "splits_failed": splits_failed,
                "migrations_running": migrations_running,
                "elastic_jobs_running": el_running,
                "elastic_jobs_failed": el_failed}

    def _h_members(self, _body, _parts) -> dict:
        """Metadata-raft membership (reference: GET /members +
        memberAdd/memberDelete, cluster_api.go:344-354). Dynamic:
        POST /members/add and /members/remove change it at runtime."""
        if self.replicated:
            leader_id = (self.node_id if self.is_leader
                         else self.meta_node.leader_hint)
        else:
            leader_id = self.node_id
        return {"members": [
            {"node_id": nid, "addr": addr, "leader": nid == leader_id}
            for nid, addr in sorted(self.peers.items())
        ]}

    # -- dynamic metadata-raft membership ------------------------------------
    #
    # Design choice (documented per r4 review next-6): SINGLE-SERVER
    # configuration changes through the replicated log (raft §4.2.2) —
    # one add/remove at a time, gated by _members_lock held across the
    # propose, applied at commit on every member. One-at-a-time keeps
    # old and new quorums overlapping without joint consensus; the
    # change entry itself commits under the OLD membership. A joiner
    # starts empty and catches up by log replay or snapshot install
    # (the snapshot carries /meta/members, reloaded on install).

    def _apply_member_change(self, op: dict):
        action = op["action"]
        nid = int(op["node_id"])
        # the op carries the FULL resulting member map, computed by the
        # proposing leader (which has the complete picture). Deriving it
        # from local self.peers here would be wrong on a joiner applying
        # its own add mid-catch-up (its peers map is just itself), and
        # that incomplete map would persist as authoritative — on
        # restart a quorum-of-1 split brain (review r5).
        new_peers = {int(k): str(v) for k, v in op["members"].items()}
        node = self.meta_node
        with self._members_lock:
            self.peers = new_peers
            with node._lock:
                node.members = sorted(new_peers)
                node._match = {p: v for p, v in node._match.items()
                               if p in node.members}
                if node.is_leader:
                    for p in node.members:
                        if p != self.node_id:
                            node._next.setdefault(
                                p, node.wal.last_index + 1)
                if action == "remove" and nid == self.node_id:
                    # removed self: stop leading/campaigning; the node
                    # stays up for reads until the operator retires it
                    node.is_leader = False
            # deterministic store write so restarts and snapshots carry
            # the membership (apply runs on every replica)
            self.store._do_put(
                "/meta/members",
                {str(i): a for i, a in sorted(new_peers.items())})
        return {"members": {str(i): a for i, a in sorted(new_peers.items())}}

    def _install_meta_snapshot(self, data: bytes) -> None:
        self.store.install_snapshot(data)
        saved = self.store.get("/meta/members")
        if saved:
            with self._members_lock:
                self.peers = {int(k): v for k, v in saved.items()}
                if self.meta_node is not None:
                    with self.meta_node._lock:
                        self.meta_node.members = sorted(self.peers)

    def _h_member_add(self, body: dict, _parts) -> dict:
        if not self.replicated:
            raise RpcError(400, "single-master mode has no member group")
        nid = int(body["node_id"])
        addr = str(body["addr"])
        with self._member_change_gate:
            with self._members_lock:
                cur = self.peers.get(nid)
                if cur is not None and cur != addr:
                    raise RpcError(
                        409, f"member {nid} exists at {cur!r}; remove it "
                             f"before re-adding at a new address")
                already = cur == addr
            if not already:
                with self._members_lock:
                    resulting = {str(i): a
                                 for i, a in sorted(self.peers.items())}
                    resulting[str(nid)] = addr
                self.meta_node.propose([{
                    "type": "member_change", "action": "add",
                    "node_id": nid, "addr": addr, "members": resulting,
                }])
        return {"members": {str(i): a
                            for i, a in sorted(self.peers.items())},
                "leader": self.node_id}

    def _h_member_remove(self, body: dict, _parts) -> dict:
        if not self.replicated:
            raise RpcError(400, "single-master mode has no member group")
        nid = int(body["node_id"])
        with self._member_change_gate:
            with self._members_lock:
                if nid not in self.peers:
                    raise RpcError(404, f"no member {nid}")
                if len(self.peers) <= 1:
                    raise RpcError(400, "cannot remove the last member")
            with self._members_lock:
                resulting = {str(i): a
                             for i, a in sorted(self.peers.items())
                             if i != nid}
            self.meta_node.propose([{
                "type": "member_change", "action": "remove",
                "node_id": nid, "members": resulting,
            }])
        return {"members": {str(i): a
                            for i, a in sorted(self.peers.items())}}

    def _h_fail_servers(self, _body, _parts) -> dict:
        return {"fail_servers": [
            {"node_id": int(k.rsplit("/", 1)[1]), **v}
            for k, v in sorted(self.store.prefix("/fail_server/").items())
        ]}

    def _h_fail_server_clear(self, _body, parts) -> dict:
        if not parts:
            raise RpcError(404, "DELETE /schedule/fail_server/{node_id}")
        node_id = int(parts[0])
        if not self.store.delete(f"/fail_server/{node_id}"):
            raise RpcError(404, f"no fail record for node {node_id}")
        return {"node_id": node_id}

    def _h_recover_server(self, body: dict, _parts) -> dict:
        """Kick replica re-placement NOW for a failed node instead of
        waiting out recover_delay (reference: RecoverFailServer)."""
        node_id = int(body["node_id"])
        key = f"/fail_server/{node_id}"
        rec = self.store.get(key)
        if rec is None:
            raise RpcError(404, f"no fail record for node {node_id}")
        # age the record past the delay gate, then run one recover pass.
        # NOTE: the pass's may_replace gate still holds re-placement
        # while ANY OTHER failure is younger than recover_delay — report
        # that honestly instead of claiming recovery started
        self.store.put(key, {**rec, "time": 0.0})
        others_fresh = any(
            int(k.rsplit("/", 1)[1]) != node_id
            and time.time() - v["time"] < self.recover_delay  # lint: allow[wall-clock] compares against the durable fail stamp, same clock
            for k, v in self.store.prefix("/fail_server/").items()
        )
        with self._reconfig_lock:
            self._auto_recover_once()
        return {"node_id": node_id,
                "recover_started": not others_fresh,
                **({"blocked_by_fresh_failures": True}
                   if others_fresh else {})}

    def _h_clean_lock(self, _body, _parts) -> dict:
        """List + clear expired space-mutation locks (reference:
        GET /clean_lock — ops escape hatch for locks orphaned by a
        crashed mutation; live locks are left alone)."""
        cleaned, held = self.store.clean_expired_locks()
        return {"cleaned": cleaned, "held": held}

    # -- servers -------------------------------------------------------------

    def _h_register(self, body: dict, _parts) -> dict:
        node_id = body.get("node_id")
        if node_id is None:
            node_id = self.store.next_id(SEQ_NODE_ID)
        node_id = int(node_id)
        key = f"{PREFIX_SERVER}{node_id}"
        existing = self.store.get(key)
        server = Server(
            node_id=node_id,
            rpc_addr=body["rpc_addr"],
            partition_ids=(existing or {}).get("partition_ids", []),
            labels=body.get("labels") or {},
        )
        lease = self._leases.get(node_id)
        refreshed = (
            lease is not None
            and self.store.keepalive(lease, self.heartbeat_ttl)
        )
        if not refreshed:
            lease = self.store.grant_lease(self.heartbeat_ttl)
            self._leases[node_id] = lease
        record = server.to_dict()
        if not refreshed or existing != record:
            # only write when something changed (or a fresh lease needs
            # binding): an unconditional put would fire a /server/ watch
            # event per 2s heartbeat, making every router clear its
            # server cache continuously and long-polls never idle
            self.store.put(key, record, lease=lease)
        if self.store.get(f"/fail_server/{node_id}") is not None:
            # guarded: an unconditional delete would cost a quorum
            # proposal on every heartbeat in replicated mode
            self.store.delete(f"/fail_server/{node_id}")
        if "partitions" in body:
            self._node_stats[node_id] = body["partitions"] or {}
        if "obs" in body:
            self._node_obs[node_id] = body["obs"] or {}
        if "load" in body:
            self._node_loads[node_id] = body["load"] or {}
        if "usage" in body:
            usage = dict(body["usage"] or {})
            usage["_mono"] = time.monotonic()
            self._node_usage[node_id] = usage
        # field-index + schema expectations for the partitions this node
        # hosts: heals replicas that missed a /field_index or
        # /ps/schema/field fan-out (transient RPC failure, or a restart
        # that reloaded a stale local schema)
        expect, schemas = self._field_index_expectations()
        hosted = {str(pid) for pid in server.partition_ids}
        # per-space recall floors (Space.slo.recall_floor) for the
        # spaces this node hosts — the PS quality monitor applies them
        # replace-not-merge, so removing a floor clears it node-side
        floors: dict[str, float] = {}
        for sp in self.store.prefix(PREFIX_SPACE).values():
            rf = (sp.get("slo") or {}).get("recall_floor")
            if rf is None:
                continue
            if any(str(p["id"]) in hosted
                   for p in sp.get("partitions", [])):
                floors[f"{sp['db_name']}/{sp['name']}"] = float(rf)
        return {"node_id": node_id,
                "field_indexes": {
                    pid: flags for pid, flags in expect.items()
                    if pid in hosted
                },
                "schema_fields": {
                    pid: flds for pid, flds in schemas.items()
                    if pid in hosted
                },
                "recall_floors": floors}

    def _h_servers(self, _body, _parts) -> dict:
        # merge the live heartbeat load into each record at read time:
        # the stored record stays heartbeat-stable (watch-quiet) while
        # routers still see queue depth / latency fresh to within one
        # heartbeat interval
        servers = []
        for d in self.store.prefix(PREFIX_SERVER).values():
            load = self._node_loads.get(int(d.get("node_id", -1)))
            servers.append({**d, "load": load} if load else dict(d))
        return {"servers": servers}

    def _alive_servers(self) -> list[Server]:
        return [
            Server.from_dict(d)
            for d in self.store.prefix(PREFIX_SERVER).values()
        ]

    # -- dbs / spaces --------------------------------------------------------

    def _h_create_db(self, body: dict, parts) -> dict:
        if len(parts) == 1:
            # POST /dbs/{db} — create db
            db = parts[0]
            if self.store.get(f"{PREFIX_DB}{db}") is not None:
                raise RpcError(409, f"db {db} exists")
            self.store.put(f"{PREFIX_DB}{db}", {"name": db, "create_time": time.time()})  # lint: allow[wall-clock] operator-facing creation stamp
            return {"name": db}
        if len(parts) == 2 and parts[1] == "spaces":
            return self._create_space(parts[0], body)
        raise RpcError(404, f"bad path {parts}")

    def _h_get_db(self, _body, parts) -> Any:
        if not parts:
            return {"dbs": list(self.store.prefix(PREFIX_DB).values())}
        db = parts[0]
        if len(parts) == 1:
            d = self.store.get(f"{PREFIX_DB}{db}")
            if d is None:
                raise RpcError(404, f"db {db} not found")
            return d
        if len(parts) == 2 and parts[1] == "spaces":
            return {"spaces": list(self.store.prefix(f"{PREFIX_SPACE}{db}/").values())}
        if len(parts) == 3 and parts[1] == "spaces":
            sp = self.store.get(f"{PREFIX_SPACE}{db}/{parts[2]}")
            if sp is None:
                raise RpcError(404, f"space {db}/{parts[2]} not found")
            detail = str(
                ((_body or {}).get("_query") or {}).get("detail", "")
            ).lower() in ("true", "1")
            if detail:
                # per-partition doc/size/status from heartbeat-borne
                # stats (reference: describe_space ?detail=true returns
                # partition doc/index counts). Heartbeats land on the
                # leader; followers forward rather than serve zeros.
                fwd = self._leader_get(
                    f"/dbs/{db}/spaces/{parts[2]}?detail=true")
                if fwd is not None:
                    return fwd
                sp = dict(sp)
                parts_out = []
                for p in sp.get("partitions", []):
                    st = {}
                    # list(): heartbeat threads mutate the dict under us
                    for node_stats in list(self._node_stats.values()):
                        got = node_stats.get(str(p["id"]))
                        if got and (not st or got.get("leader")):
                            st = got
                    parts_out.append({**p,
                                      "doc_count": st.get("doc_count", 0),
                                      "size_bytes": st.get("size_bytes", 0),
                                      "status": st.get("status")})
                sp["partitions"] = parts_out
            return sp
        raise RpcError(404, f"bad path {parts}")

    def _lock_space(self, db: str, name: str) -> str:
        """Per-space mutation lock. The lock NAME is the space (so two
        spaces mutate concurrently) and the owner a per-request token —
        try_lock re-grants to the SAME owner, so using the space as the
        owner (the old scheme) let two mutations of one space both
        acquire (a lost-update race found earlier). Raises 409 when the
        space is already being mutated."""
        token = uuid.uuid4().hex
        if not self.store.try_lock(f"space_mutate/{db}/{name}", token):
            raise RpcError(409, "space mutation in progress")
        return token

    def _unlock_space(self, db: str, name: str, token: str) -> None:
        self.store.unlock(f"space_mutate/{db}/{name}", token)

    def _h_update_space(self, body: dict, parts) -> dict:
        """PUT /dbs/{db}/spaces/{space} — online space update (reference:
        space_service.go:520 UpdateSpace): partition_num expansion and
        new-scalar-field addition; immutable properties rejected."""
        if len(parts) != 3 or parts[1] != "spaces":
            raise RpcError(404, "PUT /dbs/{db}/spaces/{space}")
        db, _, name = parts[0], parts[1], parts[2]
        key = f"{PREFIX_SPACE}{db}/{name}"
        token = self._lock_space(db, name)
        try:
            sp = self.store.get(key)
            if sp is None:
                raise RpcError(404, f"space {db}/{name} not found")
            space = Space.from_dict(sp)
            if body.get("replica_num") and \
                    int(body["replica_num"]) != space.replica_num:
                raise RpcError(400, "replica_num can not change")
            new_fields = []
            if body.get("fields"):
                new_fields = self._merge_new_fields(space, body["fields"])
            pn = int(body.get("partition_num", 0))
            if pn:
                if space.partition_rule:
                    raise RpcError(
                        400, "rule spaces grow via /partitions/rule ADD")
                if pn < space.partition_num:
                    raise RpcError(
                        400,
                        f"partition_num {pn} should be greater than "
                        f"current {space.partition_num}",
                    )
                if pn > space.partition_num:
                    # pn == current is a no-op, like echoing back an
                    # unchanged replica_num: read-modify-write clients
                    # resubmit the whole space config
                    self._expand_partitions(space, pn)
            if "slo" in body:
                # declared objective is online-mutable: routers pick
                # the change up on their next metadata fetch (one
                # cache TTL) and rescore from there
                space.slo = self._validate_slo(body.get("slo"))
            self.store.put(key, space.to_dict())
        finally:
            self._unlock_space(db, name, token)
        # fan the new fields out to live engines (a replica that misses
        # this converges via the schema expectations riding heartbeats)
        acked, failed = [], []
        if new_fields:
            servers = {s.node_id: s for s in self._alive_servers()}
            for part in space.partitions:
                for node_id in part.replicas:
                    srv = servers.get(node_id)
                    try:
                        if srv is None:
                            raise RpcError(503, "down")
                        rpc.call(srv.rpc_addr, "POST", "/ps/schema/field",
                                 {"partition_id": part.id,
                                  "fields": new_fields})
                        acked.append([part.id, node_id])
                    except RpcError:
                        failed.append([part.id, node_id])
        out = space.to_dict()
        if new_fields:
            out["fields_acked"] = acked
            out["fields_failed"] = failed
        return out

    def _merge_new_fields(self, space: Space, fields: list[dict]) -> list:
        """Append-only schema evolution: brand-new scalar fields are
        added; existing fields may not change (index changes go through
        /field_index). Returns the new fields' dicts (reference:
        updateSpaceFields, space_service.go:801 — only additions and
        index-option changes allowed)."""
        from vearch_tpu_torch.engine.types import FieldSchema

        existing = {f.name: f for f in space.schema.fields}
        added = []
        for d in fields:
            f = FieldSchema.from_dict(d)
            cur = existing.get(f.name)
            if cur is not None:
                if cur.to_dict() != f.to_dict():
                    raise RpcError(
                        400,
                        f"field {f.name!r} exists; only new fields can "
                        f"be added (index changes: POST /field_index)",
                    )
                continue
            if f.data_type is DataType.VECTOR:
                raise RpcError(
                    400, "vector fields cannot be added to a live space")
            space.schema.fields.append(f)
            added.append(f.to_dict())
        return added

    def _expand_partitions(self, space: Space, pn: int) -> None:
        """Grow a slot-sharded space to pn partitions: slots re-carve
        evenly over the new count (existing partitions keep their id,
        replicas, and data) and the new partitions are placed/created
        (reference: expandPartitions, space_service.go:785-798)."""
        servers = self._alive_servers()
        if len(servers) < max(space.replica_num, 1):
            raise RpcError(
                503,
                f"need {space.replica_num} alive servers, "
                f"have {len(servers)}",
            )
        old = space.partition_num
        space.partition_num = pn
        slots = carve_slots(pn)
        # every partition that exists BEFORE this carve may hold rows
        # that land off-slot under the new carve; record them so
        # id-routed writes probe only these (new partitions can only
        # hold correctly-slotted rows). Accumulates across repeated
        # expansions: partitions added by an earlier expansion existed
        # before this one.
        pre = set(space.pre_expand_pids)
        pre.update(p.id for p in space.partitions[:old])
        space.pre_expand_pids = sorted(pre)
        # the group creator rolls back on failure, so re-carve the
        # existing partitions' slots only after the new ones exist —
        # a failed expansion must leave the old routing intact
        self._create_partition_group(space, servers, None,
                                     slots=slots[old:])
        for i, part in enumerate(space.partitions[:old]):
            part.slot = slots[i]
        # pre-expansion rows may now live off their slot's partition:
        # id-routed reads must fan out from here on
        space.expanded = True

    def _h_delete_db(self, _body, parts) -> dict:
        if len(parts) == 1:
            db = parts[0]
            if self.store.prefix(f"{PREFIX_SPACE}{db}/"):
                raise RpcError(409, f"db {db} still has spaces")
            self.store.delete(f"{PREFIX_DB}{db}")
            return {"name": db}
        if len(parts) == 3 and parts[1] == "spaces":
            return self._delete_space(parts[0], parts[2])
        raise RpcError(404, f"bad path {parts}")

    def _h_partitions(self, _body, _parts) -> dict:
        out = []
        for sp in self.store.prefix(PREFIX_SPACE).values():
            out.extend(sp["partitions"])
        return {"partitions": out}

    def _h_cluster_info(self, _body, _parts) -> dict:
        return {
            "name": "vearch-tpu",
            "version": "0.1.0",
            "status": "green" if self._alive_servers() else "yellow",
            # which master answered, and whether it currently leads the
            # metadata raft (ops + the cluster smoke profile use this)
            "node_id": self.node_id,
            "meta_leader": self.is_leader,
        }

    # -- runtime config (reference: cluster_api.go:294-307 modifySpaceConfig)

    def _h_set_config(self, body: dict, parts) -> dict:
        if len(parts) != 2:
            raise RpcError(404, "POST /config/{db}/{space}")
        db, name = parts
        sp = self.store.get(f"{PREFIX_SPACE}{db}/{name}")
        if sp is None:
            raise RpcError(404, f"space {db}/{name} not found")
        if "log_level" in body:
            # validate BEFORE persisting/fanning out: a typo'd level
            # must reject the whole request, not store junk config
            try:
                log.parse_level(str(body["log_level"]))
            except ValueError as e:
                raise RpcError(400, str(e)) from None
        self.store.put(f"/config/{db}/{name}", body)
        if "log_level" in body:
            # the master applies the flip to itself too before fanning
            # the config out to the space's PS nodes
            log.set_level(str(body["log_level"]))
        space = Space.from_dict(sp)
        servers = {s.node_id: s for s in self._alive_servers()}
        applied = []
        for part in space.partitions:
            for node_id in part.replicas:
                srv = servers.get(node_id)
                if srv is None:
                    continue
                try:
                    applied.append(rpc.call(
                        srv.rpc_addr, "POST", "/ps/engine/config",
                        {"partition_id": part.id, "config": body},
                    ))
                except RpcError:
                    pass
        return {"applied": applied}

    def _h_get_config(self, _body, parts) -> dict:
        if len(parts) != 2:
            raise RpcError(404, "GET /config/{db}/{space}")
        return self.store.get(f"/config/{parts[0]}/{parts[1]}") or {}

    # -- aliases (reference: master alias service + entity/Alias;
    #    POST /alias/{alias}/dbs/{db}/spaces/{space}) ------------------------

    def _h_create_alias(self, _body, parts) -> dict:
        if len(parts) != 5 or parts[1] != "dbs" or parts[3] != "spaces":
            raise RpcError(404, "POST /alias/{alias}/dbs/{db}/spaces/{space}")
        alias, _, db, _, space = parts
        if self.store.get(f"{PREFIX_SPACE}{db}/{space}") is None:
            raise RpcError(404, f"space {db}/{space} not found")
        self.store.put(f"/alias/{alias}", {"name": alias, "db_name": db,
                                           "space_name": space})
        return {"name": alias}

    def _h_get_alias(self, _body, parts) -> dict:
        if parts:
            a = self.store.get(f"/alias/{parts[0]}")
            if a is None:
                raise RpcError(404, f"alias {parts[0]} not found")
            return a
        return {"aliases": list(self.store.prefix("/alias/").values())}

    def _h_delete_alias(self, _body, parts) -> dict:
        if not parts or not self.store.delete(f"/alias/{parts[0]}"):
            raise RpcError(404, "alias not found")
        return {"name": parts[0]}

    # -- backup/restore (reference: services/backup_service.go — versioned
    #    space backup to object storage, cross-cluster restore) --------------

    def _h_backup(self, body: dict, parts) -> dict:
        if len(parts) != 3 or parts[1] != "spaces":
            raise RpcError(404, "POST /backup/dbs/{db}/spaces/{space}")
        db, _, name = parts
        sp = self.store.get(f"{PREFIX_SPACE}{db}/{name}")
        if sp is None:
            raise RpcError(404, f"space {db}/{name} not found")
        space = Space.from_dict(sp)
        command = body.get("command", "create")
        # `store` spec selects the backend (local root or s3 —
        # reference: minio-configured PSShardManager); legacy
        # `store_root` remains the local-filesystem shorthand
        store_spec = body.get("store") or body["store_root"]
        from vearch_tpu_torch.cluster.objectstore import make_object_store

        ostore = make_object_store(store_spec)
        servers = {s.node_id: s for s in self._alive_servers()}
        base_prefix = f"backup/{db}/{name}"

        import json as _json
        import re as _re

        # content-addressed dedup across versions is the default
        # (reference: ref-counted shard files, ps/backup/
        # ref_count_manager.go); dedup=false keeps the flat layout
        dedup = bool(body.get("dedup", True))

        if command in ("create", "delete"):
            # serialise pool mutations per space: refs.json is a read-
            # modify-write on the PSes (create) and here (delete); two
            # concurrent commands would drop each other's ref updates
            # and a later GC could orphan a valid version
            import uuid as _uuid

            lock_owner = _uuid.uuid4().hex
            if not self.store.try_lock(f"backup/{db}/{name}", lock_owner,
                                       ttl_s=600.0):
                raise RpcError(409, f"backup for {db}/{name} in progress")
        if command == "create" and body.get("async"):
            # async create: shard jobs dispatched in parallel, progress
            # polled into a master job record, caller returns at once
            # (reference: async backups w/ progress endpoints,
            # master/cluster_api.go:330-340 + ps_backup_service.go:113).
            # The worker owns the space lock from here.
            try:
                return self._backup_create_async(
                    db, name, space, body, ostore, servers,
                    base_prefix, dedup, lock_owner)
            except BaseException:
                self.store.unlock(f"backup/{db}/{name}", lock_owner)
                raise
        try:
            if command == "create":
                version = self.store.next_id(f"/seq/backup/{db}/{name}")
                prefix = f"{base_prefix}/v{version}"
                # space metadata rides with the backup for
                # cross-cluster restore
                ostore.put_bytes(f"{prefix}/space.json",
                                 _json.dumps(space.to_dict()).encode())
                results = []
                for i, part in enumerate(sorted(space.partitions,
                                                key=lambda p: p.slot)):
                    srv = servers.get(part.leader)
                    if srv is None:
                        raise RpcError(
                            503, f"leader of partition {part.id} down"
                        )
                    results.append(
                        rpc.call(srv.rpc_addr, "POST", "/ps/backup", {
                            "partition_id": part.id,
                            "store_root": body.get("store_root"),
                            "store": body.get("store"),
                            "key_prefix": f"{prefix}/shard_{i}",
                            "pool_prefix": (
                                f"{base_prefix}/pool/shard_{i}"
                                if dedup else None
                            ),
                        })
                    )
                return {"version": version, "partitions": results}

            if command == "delete":
                version = int(body["version"])
                prefix = f"{base_prefix}/v{version}"
                try:
                    bmeta = _json.loads(
                        ostore.get_bytes(f"{prefix}/space.json")
                    )
                except (FileNotFoundError, KeyError) as e:
                    raise RpcError(
                        404, f"backup v{version} not found"
                    ) from e
                results = []
                # shard count from the BACKUP's metadata: the live
                # space may have been recreated with a different
                # partition_num, and missing a shard would leak its
                # blobs' refs forever
                for i in range(len(bmeta["partitions"])):
                    shard = f"{prefix}/shard_{i}"
                    # always decref: delete_tree_dedup scrubs this
                    # version from every pool ref (a crash between
                    # incref and manifest write leaves refs with no
                    # manifest — gating on the manifest would pin those
                    # blobs forever); flat backups have an empty pool,
                    # so the scrub is a no-op for them
                    results.append(ostore.delete_tree_dedup(
                        shard, f"{base_prefix}/pool/shard_{i}"
                    ))
                for key in ostore.list(prefix.rstrip("/") + "/"):
                    try:
                        ostore.delete(key)
                    except (FileNotFoundError, IOError):
                        pass
                return {"version": version, "shards": results}
        finally:
            if command in ("create", "delete"):
                self.store.unlock(f"backup/{db}/{name}", lock_owner)

        if command == "list":
            versions = sorted({
                int(m.group(1))
                for k in ostore.list(base_prefix)
                if (m := _re.search(rf"{_re.escape(base_prefix)}/v(\d+)/", k))
            })
            return {"versions": versions}

        if command == "restore":
            version = int(body["version"])
            prefix = f"{base_prefix}/v{version}"
            try:
                bmeta = _json.loads(ostore.get_bytes(f"{prefix}/space.json"))
            except FileNotFoundError as e:
                raise RpcError(404, f"backup v{version} not found") from e
            except IOError as e:
                # transient store trouble is NOT "backup not found"
                raise RpcError(503, f"backup store error: {e}") from e
            if len(bmeta["partitions"]) != len(space.partitions):
                raise RpcError(
                    400,
                    f"backup has {len(bmeta['partitions'])} shards but "
                    f"space has {len(space.partitions)} partitions",
                )
            results = []
            for i, part in enumerate(sorted(space.partitions,
                                            key=lambda p: p.slot)):
                if servers.get(part.leader) is None:
                    raise RpcError(503, f"leader of partition {part.id} down")
                # restore is a point-in-time rewind: every replica resets
                # to the backup state (each clears its own log), or the
                # followers would silently keep the pre-restore data
                out = None
                from vearch_tpu_torch.cluster.objectstore import DEDUP_MANIFEST

                # layout auto-detection: versions written with dedup
                # carry a dedup manifest; flat ones a plain MANIFEST
                dd = ostore.exists(
                    f"{prefix}/shard_{i}/{DEDUP_MANIFEST}"
                )
                for r in part.replicas:
                    srv = servers.get(r)
                    if srv is None:
                        continue
                    res = rpc.call(srv.rpc_addr, "POST", "/ps/restore", {
                        "partition_id": part.id,
                        "store_root": body.get("store_root"),
                        "store": body.get("store"),
                        "key_prefix": f"{prefix}/shard_{i}",
                        "pool_prefix": (
                            f"{base_prefix}/pool/shard_{i}" if dd else None
                        ),
                    })
                    if r == part.leader:
                        out = res
                results.append(out)
            # a restore rewrites partition data OUT OF BAND of the
            # write path, so router merged-result entries validated by
            # apply version can still look "current" while describing
            # pre-restore data. Re-put the space key (every router's
            # watch evicts through it) and synchronously evict entries
            # touching the restored partitions on each live router —
            # the next search recomputes against restored data.
            self.store.put(f"{PREFIX_SPACE}{db}/{name}", space.to_dict())
            pids = [p.id for p in space.partitions]
            for rt in self.store.prefix("/router/").values():
                try:
                    rpc.call(rt["addr"], "POST", "/cache/invalidate",
                             {"pids": pids}, timeout=5.0)
                except RpcError:
                    # unreachable router: its watch + entry TTL still
                    # converge, just not synchronously
                    continue
            return {"version": version, "partitions": results}

        raise RpcError(400, f"unknown backup command {command!r}")

    def _backup_create_async(self, db, name, space, body, ostore,
                             servers, base_prefix, dedup,
                             lock_owner) -> dict:
        import json as _json

        version = self.store.next_id(f"/seq/backup/{db}/{name}")
        prefix = f"{base_prefix}/v{version}"
        ostore.put_bytes(f"{prefix}/space.json",
                         _json.dumps(space.to_dict()).encode())
        job_id = f"{db}:{name}:v{version}"
        job = {
            "job_id": job_id, "db": db, "space": name, "version": version,
            "status": "running", "started": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            "updated": time.time(), "error": None,  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            "partitions": {}, "results": [],
        }
        shards = []
        for i, part in enumerate(sorted(space.partitions,
                                        key=lambda p: p.slot)):
            srv = servers.get(part.leader)
            if srv is None:
                self.store.unlock(f"backup/{db}/{name}", lock_owner)
                raise RpcError(503, f"leader of partition {part.id} down")
            shards.append((i, part, srv))
            job["partitions"][str(part.id)] = {
                "status": "pending", "files_done": 0, "files_total": None,
                "node_id": part.leader,
                # pre-seeded so later updates never RESIZE the dict — a
                # concurrent _deepcopy_job iterates it without the GIL
                # saving us from 'changed size during iteration'
                "error": None,
            }
        from vearch_tpu_torch.utils import prune_job_registry

        with self._backup_jobs_lock:
            self._backup_jobs[job_id] = job
            prune_job_registry(self._backup_jobs)
        lock_name = f"backup/{db}/{name}"
        job_timeout = float(body.get("timeout_s", 3600.0))

        def worker():
            # every job/partition mutation happens under
            # _backup_jobs_lock so the deep-copying read path
            # (_h_backup_jobs -> _deepcopy_job) sees a consistent
            # record instead of relying on GIL timing; the lock is
            # never held across an RPC — only around the dict writes
            shards_still_running = False
            try:
                running = {}
                for i, part, srv in shards:
                    sid = f"{job_id}:shard_{i}"
                    pj = job["partitions"][str(part.id)]
                    try:
                        rpc.call(srv.rpc_addr, "POST", "/ps/backup", {
                            "partition_id": part.id,
                            "store_root": body.get("store_root"),
                            "store": body.get("store"),
                            "key_prefix": f"{prefix}/shard_{i}",
                            "pool_prefix": (
                                f"{base_prefix}/pool/shard_{i}"
                                if dedup else None
                            ),
                            "job_id": sid,
                        })
                        with self._backup_jobs_lock:
                            pj["status"] = "dumping"
                        running[part.id] = (sid, srv)
                    except RpcError as e:
                        with self._backup_jobs_lock:
                            pj["status"] = "error"
                            pj["error"] = e.msg
                deadline = time.monotonic() + job_timeout
                while running and time.monotonic() < deadline:
                    # keep the space lock alive for the job's real
                    # duration (same-owner try_lock refreshes the TTL):
                    # a long upload must not let the lock lapse while
                    # PS shards still mutate the pool's refs.json
                    self.store.try_lock(lock_name, lock_owner,
                                        ttl_s=600.0)
                    for pid_, (sid, srv) in list(running.items()):
                        pj = job["partitions"][str(pid_)]
                        try:
                            st = rpc.call(
                                srv.rpc_addr, "GET",
                                f"/ps/backup/progress?job_id={sid}")
                        except RpcError:
                            continue  # transient; keep polling
                        with self._backup_jobs_lock:
                            pj.update(
                                status=st["status"],
                                files_done=st.get("files_done", 0),
                                files_total=st.get("files_total"),
                            )
                            if st["status"] == "done":
                                job["results"].append(st.get("result"))
                                del running[pid_]
                            elif st["status"] == "error":
                                pj["error"] = st.get("error")
                                del running[pid_]
                            job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
                    # CLI refreshes at 0.5s; polling much faster only
                    # burns RPCs (review r5)
                    time.sleep(0.25)
                with self._backup_jobs_lock:
                    errs = [p for p in job["partitions"].values()
                            if p["status"] == "error"]
                    if running:
                        shards_still_running = True
                        job["status"] = "error"
                        job["error"] = (
                            "timed out waiting for shards "
                            + str(sorted(running)))
                    elif errs:
                        job["status"] = "error"
                        job["error"] = "; ".join(
                            str(p.get("error")) for p in errs)
                    else:
                        job["status"] = "done"
                    job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            except Exception as e:  # job record must never stick "running"
                with self._backup_jobs_lock:
                    job.update(status="error",
                               error=f"{type(e).__name__}: {e}",
                               updated=time.time())  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            finally:
                if not shards_still_running:
                    self.store.unlock(lock_name, lock_owner)
                # else: PS shards may still be mutating the pool's
                # refs.json — leave the lock to its TTL rather than
                # open a concurrent-create window (the timeout error
                # already tells the operator what happened)

        threading.Thread(target=worker, daemon=True,
                         name=f"backup-{job_id}").start()
        return {"version": version, "job_id": job_id, "status": "running"}

    def _h_backup_jobs(self, body, parts) -> dict:
        """Master backup-job progress (reference: backup progress routes,
        master/cluster_api.go:330-340). GET /backup/jobs lists; GET
        /backup/jobs/{job_id} details one (job ids contain ':', so they
        arrive as a single path part). Job records live on the leader
        (the worker runs there), so followers forward like the other
        leader-state GETs."""
        fwd = self._leader_get(
            "/backup/jobs" + (f"/{parts[0]}" if parts else ""))
        if fwd is not None:
            return fwd
        with self._backup_jobs_lock:
            if parts:
                job = self._backup_jobs.get(parts[0])
                if job is None:
                    raise RpcError(404, f"no backup job {parts[0]}")
                return _deepcopy_job(job)
            return {"jobs": [_deepcopy_job(j)
                             for j in self._backup_jobs.values()]}

    # -- elastic data plane: online split, snapshot-streamed replica
    #    migration, load-aware rebalancing (reference: the partition
    #    admin verbs in master/cluster_api.go + etcd-raft learner
    #    promotion). Every verb runs as an observable async job:
    #    GET /cluster/jobs, /cluster/health rollup, and the
    #    vearch_partition_splits_total / vearch_replica_migrations_total
    #    / vearch_elastic_jobs_running metrics. ---------------------------

    def _new_elastic_job(self, op: str, detail: dict) -> dict:
        from vearch_tpu_torch.utils import prune_job_registry

        job_id = f"{op}-{self.store.next_id('/seq/elastic_job')}"
        job = {
            "job_id": job_id, "op": op, "status": "running",
            "phase": "init", "error": None,
            "started": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            "updated": time.time(),  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            "detail": dict(detail), "steps": [],
        }
        with self._elastic_jobs_lock:
            self._elastic_jobs[job_id] = job
            prune_job_registry(self._elastic_jobs)
        return job

    def _ejob_update(self, job: dict, phase: str | None = None,
                     **detail) -> None:
        with self._elastic_jobs_lock:
            if phase is not None:
                job["phase"] = phase
            job["detail"].update(detail)
            job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally

    def _ejob_finish(self, job: dict, error: str | None) -> None:
        with self._elastic_jobs_lock:
            job["status"] = "error" if error else "done"
            job["error"] = error
            job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally

    def _h_elastic_jobs(self, _body, parts) -> dict:
        """GET /cluster/jobs[/{job_id}] — elastic-job progress. Records
        live on the leader (the workers run there), so followers forward
        like the other leader-state GETs."""
        fwd = self._leader_get(
            "/cluster/jobs" + (f"/{parts[0]}" if parts else ""))
        if fwd is not None:
            return fwd
        with self._elastic_jobs_lock:
            if parts:
                job = self._elastic_jobs.get(parts[0])
                if job is None:
                    raise RpcError(404, f"no elastic job {parts[0]}")
                return _deepcopy_ejob(job)
            return {"jobs": [_deepcopy_ejob(j)
                             for j in self._elastic_jobs.values()]}

    def _find_partition(self, pid: int):
        """(space key, space dict, partition dict) or None."""
        for key, sp in self.store.prefix(PREFIX_SPACE).items():
            for p in sp["partitions"]:
                if int(p["id"]) == pid:
                    return key, sp, p
        return None

    def _load_spaces(self) -> list[Space]:
        return [Space.from_dict(d)
                for d in self.store.prefix(PREFIX_SPACE).values()]

    # -- online partition split ----------------------------------------------

    def _h_split(self, body: dict, _parts) -> dict:
        """POST /partitions/split {db_name, space_name, partition_id} —
        split a hot partition online: hash-range halves, PS-side
        copy + double-write mirror, atomic versioned router-map flip.
        Validates synchronously, then runs as an observable async job
        (poll GET /cluster/jobs/{job_id})."""
        db, name = body["db_name"], body["space_name"]
        pid = int(body["partition_id"])
        key = f"{PREFIX_SPACE}{db}/{name}"
        sp = self.store.get(key)
        if sp is None:
            raise RpcError(404, f"space {db}/{name} not found")
        space = Space.from_dict(sp)
        try:
            elastic.split_ranges(space, pid)
        except ValueError as e:
            raise RpcError(400, str(e)) from None
        parent = next(p for p in space.partitions if p.id == pid)
        servers = {s.node_id: s for s in self._alive_servers()}
        if parent.leader not in servers:
            raise RpcError(503, f"leader of partition {pid} down")
        timeout_s = float(body.get("timeout_s", 600.0))
        # the worker owns the space lock from here (the async-backup
        # idiom: held with TTL refresh for the job's real duration)
        token = self._lock_space(db, name)
        job = self._new_elastic_job("split", {
            "db": db, "space": name, "partition_id": pid,
            "children": [], "ps_phase": None,
            "docs_done": 0, "docs_total": 0,
        })
        try:
            threading.Thread(
                target=self._run_split_job,
                args=(job, db, name, pid, token, timeout_s),
                daemon=True, name=f"elastic-{job['job_id']}").start()
        except BaseException:
            self._unlock_space(db, name, token)
            raise
        return {"job_id": job["job_id"], "status": "running",
                "partition_id": pid}

    def _run_split_job(self, job, db, name, pid, token,
                       timeout_s) -> None:
        key = f"{PREFIX_SPACE}{db}/{name}"
        lock_name = f"space_mutate/{db}/{name}"
        children: list[Partition] = []
        leader_addr = None
        started = flipped = False
        err = None
        try:
            # re-read under the held lock: the handler's check was
            # advisory and the space may have mutated since
            sp = self.store.get(key)
            if sp is None:
                raise RpcError(404, f"space {db}/{name} vanished")
            space = Space.from_dict(sp)
            parent = next(
                (p for p in space.partitions if p.id == pid), None)
            if parent is None:
                raise RpcError(404, f"partition {pid} not in {db}/{name}")
            try:
                lo, mid, hi = elastic.split_ranges(space, pid)
            except ValueError as e:
                raise RpcError(400, str(e)) from None
            servers = {s.node_id: s for s in self._alive_servers()}
            leader_srv = servers.get(parent.leader)
            if leader_srv is None:
                raise RpcError(503, f"leader of partition {pid} down")
            leader_addr = leader_srv.rpc_addr

            # 1. mint + place + create the children. NOT yet routed:
            # they join the space record only at the atomic flip below,
            # so a crash before that leaves the parent serving alone
            # and the children as garbage the error path collects.
            self._ejob_update(job, phase="create_children")
            bounds = ((lo, mid), (mid, hi))
            for slo, _shi in bounds:
                cid = self.store.next_id(SEQ_PARTITION_ID)
                replicas = self._place_replicas(
                    space, list(servers.values()))
                child = Partition(
                    id=cid, space_id=space.id, db_name=db,
                    space_name=name, slot=slo, replicas=replicas,
                    leader=replicas[0], group=parent.group,
                    # minted under the post-flip epoch: responses from
                    # the children tell stale routers to reload
                    map_version=space.map_version + 1,
                )
                children.append(child)
                for nid in replicas:
                    srv = servers[nid]
                    rpc.call(srv.rpc_addr, "POST",
                             "/ps/partition/create",
                             {"partition": child.to_dict(),
                              "schema": space.schema.to_dict()})
                    srv.partition_ids.append(cid)
                    self.store.put(f"{PREFIX_SERVER}{nid}",
                                   srv.to_dict())
            self._ejob_update(job, children=[c.id for c in children])

            # 2. PS-side pipeline on the parent leader: bulk copy →
            # mirror catch-up → synchronous double-writes → cutover_ready
            self._ejob_update(job, phase="copy")
            wire = [{"id": c.id, "slot_lo": b[0], "slot_hi": b[1],
                     "leader": c.leader}
                    for c, b in zip(children, bounds)]
            rpc.call(leader_addr, "POST", "/ps/partition/split/start",
                     {"partition_id": pid, "children": wire},
                     timeout=30.0)
            started = True
            deadline = time.monotonic() + timeout_s
            misses = 0
            while True:
                # same-owner try_lock refreshes the space-lock TTL for
                # the job's real duration (the backup worker's idiom)
                self.store.try_lock(lock_name, token, ttl_s=600.0)
                try:
                    st = rpc.call(
                        leader_addr, "GET",
                        f"/ps/partition/split/progress?partition_id={pid}")
                    misses = 0
                except RpcError:
                    # tolerate transient poll failures; a dead parent
                    # leader surfaces as 10 consecutive misses
                    misses += 1
                    if misses >= 10:
                        raise
                    time.sleep(0.3)
                    continue
                self._ejob_update(
                    job, ps_phase=st.get("phase"),
                    docs_done=st.get("docs_done", 0),
                    docs_total=st.get("docs_total", 0),
                    mirrored=st.get("mirrored", 0))
                if st.get("status") == "error":
                    raise RpcError(
                        503, f"ps split failed: {st.get('error')}")
                if st.get("phase") == "cutover_ready":
                    break
                if time.monotonic() > deadline:
                    raise RpcError(503, "split copy/catch-up timed out")
                time.sleep(0.25)

            # 3. atomic router flip: ONE versioned store.put swaps the
            # parent for its children — the watch fires and routers
            # reload; a stale router that still writes to the parent
            # converges via the response-carried map_version (the
            # parent keeps sync-mirroring until deleted)
            self._ejob_update(job, phase="cutover")
            sp = self.store.get(key)
            space = Space.from_dict(sp)
            keep = [p for p in space.partitions if p.id != pid]
            space.partitions = sorted(keep + children,
                                      key=lambda p: p.slot)
            if not space.partition_rule:
                space.partition_num = len(space.partitions)
            space.map_version += 1
            self.store.put(key, space.to_dict())
            flipped = True

            # 4. commit on the parent leader (releases the sync-write
            # window), then retire the parent everywhere — the delete
            # IS the PS job's finalization (it drains the mirror first)
            rpc.call(leader_addr, "POST", "/ps/partition/split/finish",
                     {"partition_id": pid, "commit": True}, timeout=60.0)
            self._ejob_update(job, phase="retire_parent")
            self._drop_partitions([parent], list(servers.values()))
        except RpcError as e:
            err = e.msg
        except Exception as e:  # the record must never stick "running"
            _log.error("split job %s failed: %s: %s", job["job_id"],
                       type(e).__name__, e)
            err = f"{type(e).__name__}: {e}"
        finally:
            if err is not None and not flipped:
                # failed before the flip: abort the PS-side mirror and
                # garbage-collect the children so a retry starts clean;
                # the parent keeps serving untouched
                if started and leader_addr:
                    try:
                        rpc.call(leader_addr, "POST",
                                 "/ps/partition/split/finish",
                                 {"partition_id": pid, "commit": False},
                                 timeout=60.0)
                    except RpcError:
                        pass  # parent PS gone: its job died with it
                try:
                    self._drop_partitions(children,
                                          self._alive_servers())
                except Exception as e:
                    _log.error("split %s: child GC failed: %s: %s",
                               job["job_id"], type(e).__name__, e)
            self._m_splits.inc("error" if err else "done")
            self._ejob_finish(job, err)
            self._unlock_space(db, name, token)

    # -- snapshot-streamed replica migration ---------------------------------

    def _h_migrate(self, body: dict, _parts) -> dict:
        """POST /partitions/migrate {partition_id, to_node[, from_node]}
        — move one replica via raft-learner catch-up (chunked engine
        snapshot when behind the WAL horizon), promote to voter, retire
        the source. The serving leader never stops; routers retry the
        brief swap window, so clients see zero failed queries."""
        pid = int(body["partition_id"])
        to_node = int(body["to_node"])
        located = self._find_partition(pid)
        if located is None:
            raise RpcError(404, f"partition {pid} not found")
        _key, _sp, p = located
        replicas = [int(r) for r in p["replicas"]]
        if "from_node" in body:
            from_node = int(body["from_node"])
        else:
            # default: prefer moving a follower so leadership stays put
            others = [r for r in replicas if r != int(p["leader"])]
            from_node = others[0] if others else int(p["leader"])
        if from_node not in replicas:
            raise RpcError(400, f"node {from_node} holds no replica of "
                                f"partition {pid}")
        if to_node in replicas:
            raise RpcError(400, f"node {to_node} already holds a "
                                f"replica of partition {pid}")
        if not any(s.node_id == to_node for s in self._alive_servers()):
            raise RpcError(404, f"node {to_node} not alive")
        timeout_s = float(body.get("timeout_s", 600.0))
        job = self._new_elastic_job("migrate", {
            "partition_id": pid, "from_node": from_node,
            "to_node": to_node, "lag": None})

        def worker():
            try:
                self._migrate_one(
                    pid, from_node, to_node,
                    lambda **kw: self._ejob_update(job, **kw),
                    timeout_s=timeout_s)
                self._m_migrations.inc("done")
                self._ejob_finish(job, None)
            except RpcError as e:
                self._m_migrations.inc("error")
                self._ejob_finish(job, e.msg)
            except Exception as e:
                _log.error("migrate job %s failed: %s: %s",
                           job["job_id"], type(e).__name__, e)
                self._m_migrations.inc("error")
                self._ejob_finish(job, f"{type(e).__name__}: {e}")

        threading.Thread(target=worker, daemon=True,
                         name=f"elastic-{job['job_id']}").start()
        return {"job_id": job["job_id"], "status": "running",
                "partition_id": pid, "from_node": from_node,
                "to_node": to_node}

    def _migrate_one(self, pid: int, from_node: int, to_node: int,
                     upd, timeout_s: float = 600.0) -> None:
        """Move one replica of `pid` from `from_node` to `to_node`:

        1. create on the target as a raft LEARNER — it receives appends
           and (when behind the WAL compaction horizon) the chunked
           engine snapshot stream, but never votes or counts toward
           quorum, so a slow catch-up cannot stall serving;
        2. poll the leader's per-peer lag until the learner caught up;
        3. swap: fence at a bumped term, verify the target's log covers
           the leader's last entry (every committed write lives on the
           leader, so this proves no acked write can be lost), decree
           the new membership with the target as a voter and the source
           removed; writes that raced the lag check re-appoint the old
           leader for another catch-up round;
        4. retire the source replica.

        Raises RpcError on failure; the partition keeps serving from
        its original members in every failure mode (the learner is
        outside the quorum until step 3's decree)."""
        located = self._find_partition(pid)
        if located is None:
            raise RpcError(404, f"partition {pid} not found")
        key, sp, p = located
        replicas = sorted(int(r) for r in p["replicas"])
        if from_node not in replicas:
            raise RpcError(400, f"node {from_node} holds no replica of "
                                f"partition {pid}")
        if to_node in replicas:
            raise RpcError(400, f"node {to_node} already holds a "
                                f"replica of partition {pid}")
        servers = {s.node_id: s for s in self._alive_servers()}
        target = servers.get(to_node)
        if target is None:
            raise RpcError(404, f"node {to_node} not alive")
        leader = int(p["leader"])
        leader_srv = servers.get(leader)
        if leader_srv is None:
            raise RpcError(503, f"partition {pid} is leaderless")

        upd(phase="prepare", partition_id=pid, from_node=from_node,
            to_node=to_node)
        learners = sorted(set(int(x) for x in p.get("learners", []))
                          | {to_node})
        part = dict(p)
        part["learners"] = learners
        try:
            rpc.call(target.rpc_addr, "POST", "/ps/partition/create",
                     {"partition": part, "schema": sp["schema"]})
        except RpcError as e:
            if e.code != 409:  # already hosted (a resumed job): go on
                raise
        with self._reconfig_lock:
            term1 = int(p.get("term", 1)) + 1
            rpc.call(leader_srv.rpc_addr, "POST", "/ps/raft/lead",
                     {"pid": pid, "term": term1, "members": replicas,
                      "learners": learners})
            for r in replicas + [to_node]:
                if r == leader:
                    continue
                srv = servers.get(r)
                if srv is None:
                    continue
                try:
                    rpc.call(srv.rpc_addr, "POST", "/ps/raft/members",
                             {"pid": pid, "term": term1,
                              "members": replicas, "leader": leader,
                              "learners": learners})
                except RpcError:
                    pass  # a missed follower converges on the swap decree
            p["term"] = term1
            p["learners"] = learners
            self.store.put(key, sp)

        upd(phase="catchup")
        deadline = time.monotonic() + timeout_s
        misses = 0
        while True:
            try:
                st = rpc.call(leader_srv.rpc_addr, "GET",
                              f"/ps/raft/state/{pid}")
                misses = 0
            except RpcError:
                misses += 1
                if misses >= 10:
                    raise
                time.sleep(0.3)
                continue
            info = (st.get("peers") or {}).get(str(to_node)) or {}
            lag = info.get("lag")
            upd(lag=lag)
            if lag == 0:
                break
            if time.monotonic() > deadline:
                raise RpcError(503, f"learner {to_node} catch-up timed "
                                    f"out (lag={lag})")
            time.sleep(0.2)

        upd(phase="swap")
        new_members = sorted(set(replicas) - {from_node} | {to_node})
        new_leader = leader if leader != from_node else to_node
        term = int(p["term"])
        for _attempt in range(20):
            term += 1
            states = {}
            for r in sorted(set(replicas) | {to_node}):
                srv = servers.get(r)
                if srv is None:
                    continue
                try:
                    states[r] = rpc.call(srv.rpc_addr, "POST",
                                         "/ps/raft/fence",
                                         {"pid": pid, "term": term})
                except RpcError:
                    continue
            if leader not in states or to_node not in states:
                raise RpcError(503,
                               f"fence failed for partition {pid}")
            gap = (int(states[leader]["last_index"])
                   - int(states[to_node]["last_index"]))
            if gap <= 0:
                break
            # writes raced the lag check: resume the old leadership so
            # replication continues, then fence again next round
            rpc.call(leader_srv.rpc_addr, "POST", "/ps/raft/lead",
                     {"pid": pid, "term": term, "members": replicas,
                      "learners": learners})
            upd(lag=gap)
            time.sleep(0.2)
        else:
            raise RpcError(503, f"learner {to_node} kept lagging "
                                f"through the swap window")
        with self._reconfig_lock:
            rpc.call(servers[new_leader].rpc_addr, "POST",
                     "/ps/raft/lead",
                     {"pid": pid, "term": term, "members": new_members,
                      "learners": []})
            for r in new_members:
                if r == new_leader:
                    continue
                srv = servers.get(r)
                if srv is None:
                    continue
                try:
                    rpc.call(srv.rpc_addr, "POST", "/ps/raft/members",
                             {"pid": pid, "term": term,
                              "members": new_members,
                              "leader": new_leader, "learners": []})
                except RpcError:
                    pass
            p["replicas"] = new_members
            p["leader"] = new_leader
            p["term"] = term
            p["learners"] = []
            # promotion watermark for later reconfigures (same contract
            # as _reconfigure_partition): the new leader was verified to
            # cover the incumbent's log, so its fenced position bounds
            # everything committed so far
            p["promoted_log"] = [int(states[new_leader]["last_term"]),
                                 int(states[new_leader]["last_index"])]
            self.store.put(key, sp)
            if pid not in target.partition_ids:
                target.partition_ids.append(pid)
                self.store.put(f"{PREFIX_SERVER}{to_node}",
                               target.to_dict())
            src = servers.get(from_node)
            if src is not None and pid in src.partition_ids:
                src.partition_ids.remove(pid)
                self.store.put(f"{PREFIX_SERVER}{from_node}",
                               src.to_dict())

        # retire the source replica (best-effort: a dead source's
        # on-disk copy is inert — it is no longer in the membership)
        upd(phase="retire_source")
        src = servers.get(from_node)
        if src is not None:
            try:
                rpc.call(src.rpc_addr, "POST", "/ps/partition/delete",
                         {"partition_id": pid})
            except RpcError:
                pass
        upd(phase="done", lag=0)

    # -- load-aware rebalancing + drain --------------------------------------

    def _h_plan(self, _body, _parts) -> dict:
        """GET /cluster/plan — the load-aware plan, read-only: imbalance
        score, suggested replica moves, suggested splits. Heartbeat
        stats live on the leader; followers forward."""
        fwd = self._leader_get("/cluster/plan")
        if fwd is not None:
            return fwd
        return elastic.compute_plan(self._load_spaces(),
                                    self._alive_servers(),
                                    self._node_stats)

    def _h_rebalance(self, body: dict, _parts) -> dict:
        """POST /cluster/rebalance {apply} — compute the plan; with
        apply=true, execute its moves as one sequential job. Splits are
        returned as suggestions for the operator (POST
        /partitions/split) and never auto-run: they rewrite the routing
        map."""
        body = body or {}
        plan = elastic.compute_plan(
            self._load_spaces(), self._alive_servers(),
            self._node_stats,
            max_moves=int(body.get("max_moves", 4)))
        if not bool(body.get("apply")) or not plan["moves"]:
            return {**plan, "applied": False}
        job = self._new_elastic_job(
            "rebalance", {"imbalance": plan["imbalance"],
                          "total": len(plan["moves"])})
        with self._elastic_jobs_lock:
            job["steps"] = [{**m, "status": "pending", "error": None}
                            for m in plan["moves"]]
        threading.Thread(target=self._run_moves_job, args=(job,),
                         daemon=True,
                         name=f"elastic-{job['job_id']}").start()
        return {**plan, "applied": True, "job_id": job["job_id"]}

    def _h_drain(self, body: dict, _parts) -> dict:
        """POST /cluster/drain {node_id, apply} — plan (default) or run
        migrating every replica off a PS so it can be retired. 409 when
        any partition has nowhere to go without co-locating."""
        node_id = int(body["node_id"])
        servers = {s.node_id: s for s in self._alive_servers()}
        if node_id not in servers:
            raise RpcError(404, f"node {node_id} not registered")
        moves = self._drain_plan(node_id, servers)
        if not bool(body.get("apply")):
            return {"node_id": node_id, "moves": moves,
                    "applied": False}
        job = self._new_elastic_job("drain", {"node_id": node_id,
                                              "total": len(moves)})
        with self._elastic_jobs_lock:
            job["steps"] = [{**m, "status": "pending", "error": None}
                            for m in moves]
        threading.Thread(target=self._run_moves_job, args=(job,),
                         daemon=True,
                         name=f"elastic-{job['job_id']}").start()
        return {"node_id": node_id, "job_id": job["job_id"],
                "status": "running", "moves": moves}

    def _drain_plan(self, node_id: int, servers: dict) -> list[dict]:
        moves = []
        loads = elastic.node_loads(list(servers.values()),
                                   self._node_stats)
        # simulate against a moving load map so successive picks spread
        # over the targets instead of dogpiling the single coldest node
        sim = dict(loads)
        for _key, sp in sorted(self.store.prefix(PREFIX_SPACE).items()):
            for p in sp["partitions"]:
                if node_id not in p["replicas"]:
                    continue
                cands = [n for n in servers
                         if n != node_id and n not in p["replicas"]]
                if not cands:
                    raise RpcError(
                        409,
                        f"partition {p['id']}: no alive node outside "
                        f"its replica set — draining node {node_id} "
                        f"would co-locate replicas")
                st = self._node_stats.get(node_id, {}).get(
                    str(p["id"]))
                w = float((st or {}).get("size_bytes", 0) or 0)
                tgt = min(cands, key=lambda n: (sim.get(n, 0.0), n))
                sim[tgt] = sim.get(tgt, 0.0) + w
                sim[node_id] = sim.get(node_id, 0.0) - w
                moves.append({"partition_id": int(p["id"]),
                              "from_node": node_id, "to_node": tgt,
                              "reason": "drain"})
        return moves

    def _run_moves_job(self, job: dict) -> None:
        """Sequential executor for a list of migration steps (drain and
        rebalance-apply share it): one partition in flight at a time,
        so at most one extra copy of any partition's data exists."""
        failed = 0

        def upd(**kw):
            with self._elastic_jobs_lock:
                if "phase" in kw:
                    job["phase"] = kw.pop("phase")
                job["detail"].update(kw)
                job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally

        for step in list(job["steps"]):
            with self._elastic_jobs_lock:
                step["status"] = "running"
                job["updated"] = time.time()  # lint: allow[wall-clock] operator-facing job timestamp, ordering-only internally
            try:
                self._migrate_one(step["partition_id"],
                                  step["from_node"], step["to_node"],
                                  upd)
                self._m_migrations.inc("done")
                with self._elastic_jobs_lock:
                    step["status"] = "done"
            except RpcError as e:
                failed += 1
                self._m_migrations.inc("error")
                with self._elastic_jobs_lock:
                    step["status"] = "error"
                    step["error"] = e.msg
            except Exception as e:
                failed += 1
                self._m_migrations.inc("error")
                _log.error("elastic job %s step p%s failed: %s: %s",
                           job["job_id"], step["partition_id"],
                           type(e).__name__, e)
                with self._elastic_jobs_lock:
                    step["status"] = "error"
                    step["error"] = f"{type(e).__name__}: {e}"
        self._ejob_finish(
            job, f"{failed} move(s) failed" if failed else None)

    def _auto_rebalance_loop(self) -> None:
        """Opt-in closed loop (auto_rebalance=True, default off):
        periodically apply the planner's moves when the cluster is
        imbalanced and no elastic job is already in flight. Splits stay
        operator-driven even here."""
        while not self._stop.is_set():
            self._stop.wait(self.rebalance_interval)
            if self._stop.is_set() or not self.is_leader:
                continue
            try:
                with self._elastic_jobs_lock:
                    busy = any(j["status"] == "running"
                               for j in self._elastic_jobs.values())
                if busy:
                    continue
                plan = elastic.compute_plan(self._load_spaces(),
                                            self._alive_servers(),
                                            self._node_stats)
                if not plan["moves"]:
                    continue
                job = self._new_elastic_job(
                    "rebalance", {"imbalance": plan["imbalance"],
                                  "total": len(plan["moves"]),
                                  "auto": True})
                with self._elastic_jobs_lock:
                    job["steps"] = [{**m, "status": "pending",
                                     "error": None}
                                    for m in plan["moves"]]
                self._run_moves_job(job)
            except Exception as e:
                _log.error("auto-rebalance pass failed: %s: %s",
                           type(e).__name__, e)

    # -- space create (reference: services/space_service.go:59) --------------

    def _create_space(self, db: str, body: dict) -> dict:
        if self.store.get(f"{PREFIX_DB}{db}") is None:
            raise RpcError(404, f"db {db} not found")
        name = body["name"]
        key = f"{PREFIX_SPACE}{db}/{name}"
        if self.store.get(key) is not None:
            raise RpcError(409, f"space {db}/{name} exists")
        token = self._lock_space(db, name)
        try:
            schema = TableSchema.from_dict(
                {"name": name, **{k: body[k] for k in ("fields",) if k in body},
                 "training_threshold": body.get("training_threshold", 0),
                 "refresh_interval_ms": body.get("refresh_interval_ms", 1000)}
            )
            partition_num = int(body.get("partition_num", 1))
            replica_num = int(body.get("replica_num", 1))
            servers = self._alive_servers()
            if not servers:
                raise RpcError(503, "no partition servers registered")
            if replica_num > len(servers):
                raise RpcError(
                    400,
                    f"replica_num {replica_num} > {len(servers)} servers",
                )
            rule = body.get("partition_rule")
            if rule is not None:
                self._validate_rule(rule, schema)
            space_id = self.store.next_id(SEQ_SPACE_ID)
            anti = str(body.get("anti_affinity", "none"))
            if anti not in ("none", "host", "rack", "zone"):
                raise RpcError(
                    400, f"anti_affinity {anti!r} must be one of "
                         f"none/host/rack/zone"
                )
            slo = self._validate_slo(body.get("slo"))
            space = Space(
                id=space_id, name=name, db_name=db, schema=schema,
                partition_num=partition_num, replica_num=replica_num,
                partition_rule=rule, anti_affinity=anti,
                enable_id_cache=bool(body.get("enable_id_cache", True)),
                slo=slo,
            )
            # with a partition rule, every range backs its own group of
            # partition_num slot-sharded partitions (reference: a 3-range
            # rule with partition_num=2 yields 6 partitions)
            groups = [r["name"] for r in rule["ranges"]] if rule else [None]
            for group in groups:
                self._create_partition_group(space, servers, group)
            self.store.put(key, space.to_dict())
            return space.to_dict()
        finally:
            self._unlock_space(db, name, token)

    @staticmethod
    def _validate_slo(slo) -> dict | None:
        """Sanity-check a declared space SLO at admission time so the
        router's burn-rate math never divides by a nonsense budget."""
        if not slo:
            return None
        if not isinstance(slo, dict):
            raise RpcError(400, "slo must be an object")
        out: dict = {}
        if slo.get("latency_ms") is not None:
            lat = float(slo["latency_ms"])
            if lat <= 0:
                raise RpcError(400, "slo.latency_ms must be > 0")
            out["latency_ms"] = lat
        if slo.get("availability") is not None:
            avail = float(slo["availability"])
            if not 0.0 < avail < 1.0:
                raise RpcError(
                    400, "slo.availability must be in (0, 1)")
            out["availability"] = avail
        if slo.get("fast_burn_threshold") is not None:
            thr = float(slo["fast_burn_threshold"])
            if thr <= 0:
                raise RpcError(400, "slo.fast_burn_threshold must be > 0")
            out["fast_burn_threshold"] = thr
        if slo.get("recall_floor") is not None:
            # shadow-sampled recall objective: PS nodes receive it via
            # the register response and flag a statistical breach
            # (docs/QUALITY.md); /cluster/health degrades to yellow
            floor = float(slo["recall_floor"])
            if not 0.0 < floor <= 1.0:
                raise RpcError(400, "slo.recall_floor must be in (0, 1]")
            out["recall_floor"] = floor
        if not any(k in out for k in
                   ("latency_ms", "availability", "recall_floor")):
            raise RpcError(
                400, "slo must declare latency_ms, availability "
                     "and/or recall_floor")
        return out

    def _validate_rule(self, rule: dict, schema: TableSchema) -> None:
        from vearch_tpu_torch.cluster.entities import rule_value_ns

        if rule.get("type") != "RANGE":
            raise RpcError(400, "only partition rule type RANGE supported")
        fname = rule.get("field", "")
        fields = {f.name for f in schema.scalar_fields()}
        if fname not in fields:
            raise RpcError(400, f"partition rule field {fname!r} not in "
                                f"space fields")
        ranges = rule.get("ranges") or []
        if not ranges:
            raise RpcError(400, "empty partition rule ranges")
        names = [r.get("name") for r in ranges]
        if len(set(names)) != len(names) or not all(names):
            raise RpcError(400, f"range names must be unique/non-empty: "
                                f"{names}")
        try:
            vals = [rule_value_ns(r["value"]) for r in ranges]
        except (ValueError, KeyError) as e:
            raise RpcError(400, f"bad range value: {e}") from e
        if vals != sorted(vals) or len(set(vals)) != len(vals):
            raise RpcError(400, "range values must be strictly increasing")

    def _place_replicas(self, space: Space, servers) -> list[int]:
        """Replica placement: least-loaded with anti-affinity by the
        space's strategy (reference: config.go:389 none/host/rack/zone;
        space_service.go:1272 placement). Delegates to the pure planner
        (elastic.place_replicas): strict no-co-location by node — the
        old inline version could either co-locate two replicas on one
        PS or crash, depending on pool order — plus least-loaded-by-
        reported-bytes preference and a deterministic tie-break. Load
        spreads across successive placements because the caller appends
        to partition_ids between calls."""
        try:
            return elastic.place_replicas(space, list(servers),
                                          self._node_stats)
        except ValueError as e:
            raise RpcError(400, str(e)) from None

    def _create_partition_group(self, space: Space, servers, group,
                                slots: list[int] | None = None) -> None:
        """Create one group of slot-sharded partitions with anti-affine
        least-loaded replica placement (reference:
        space_service.go:141-149). `slots` defaults to a fresh carve of
        partition_num; expansion passes just the new tail. A mid-way PS
        failure rolls the whole group back — already-created engines are
        dropped and server records restored — so a failed create/expand
        leaves no orphan engines or phantom partition_ids behind."""
        if slots is None:
            slots = carve_slots(space.partition_num)
        created: list[Partition] = []
        by_id = {s.node_id: s for s in servers}
        try:
            for slot in slots:
                pid = self.store.next_id(SEQ_PARTITION_ID)
                replicas = self._place_replicas(space, servers)
                part = Partition(
                    id=pid, space_id=space.id, db_name=space.db_name,
                    space_name=space.name, slot=slot, replicas=replicas,
                    leader=replicas[0], group=group,
                )
                created.append(part)
                for node_id in replicas:
                    srv = by_id[node_id]
                    rpc.call(srv.rpc_addr, "POST", "/ps/partition/create", {
                        "partition": part.to_dict(),
                        "schema": space.schema.to_dict(),
                    })
                    srv.partition_ids.append(pid)
                    self.store.put(f"{PREFIX_SERVER}{node_id}",
                                   srv.to_dict())
                space.partitions.append(part)
        except RpcError:
            self._drop_partitions(created, servers)
            space.partitions = [
                p for p in space.partitions
                if p.id not in {c.id for c in created}
            ]
            raise

    def _h_partition_rule(self, body: dict, _parts) -> dict:
        """Online add/drop of rule partitions (reference:
        test_module_partition.py:268 update_space_partition_rule with
        operator_type ADD/DROP)."""
        from vearch_tpu_torch.cluster.entities import rule_value_ns

        db, name = body["db_name"], body["space_name"]
        key = f"{PREFIX_SPACE}{db}/{name}"
        # same lock as space create: concurrent ADD/DROP (or a racing
        # space delete) would read-modify-write over each other
        token = self._lock_space(db, name)
        try:
            return self._partition_rule_locked(body, db, name, key)
        finally:
            self._unlock_space(db, name, token)

    def _partition_rule_locked(self, body, db, name, key) -> dict:
        from vearch_tpu_torch.cluster.entities import rule_value_ns

        sp = self.store.get(key)
        if sp is None:
            raise RpcError(404, f"space {db}/{name} not found")
        space = Space.from_dict(sp)
        if not space.partition_rule:
            raise RpcError(400, f"space {db}/{name} has no partition rule")
        op = body.get("operator_type", "ADD").upper()
        servers = self._alive_servers()
        if op == "DROP":
            pname = body["partition_name"]
            ranges = space.partition_rule["ranges"]
            if pname not in {r["name"] for r in ranges}:
                raise RpcError(404, f"rule partition {pname!r} not found")
            space.partition_rule["ranges"] = [
                r for r in ranges if r["name"] != pname
            ]
            doomed = [p for p in space.partitions if p.group == pname]
            space.partitions = [
                p for p in space.partitions if p.group != pname
            ]
            self._drop_partitions(doomed, servers)
        elif op == "ADD":
            new_ranges = (body.get("partition_rule") or {}).get("ranges", [])
            if not new_ranges:
                raise RpcError(400, "ADD requires partition_rule.ranges")
            if len(servers) < max(space.replica_num, 1):
                raise RpcError(
                    503,
                    f"need {space.replica_num} alive servers for new "
                    f"partitions, have {len(servers)}",
                )
            merged = space.partition_rule["ranges"] + list(new_ranges)
            merged.sort(key=lambda r: rule_value_ns(r["value"]))
            probe = {**space.partition_rule, "ranges": merged}
            self._validate_rule(probe, space.schema)
            space.partition_rule = probe
            for r in new_ranges:
                self._create_partition_group(space, servers, r["name"])
        else:
            raise RpcError(400, f"unknown operator_type {op!r}")
        self.store.put(key, space.to_dict())
        return space.to_dict()

    def _h_field_index(self, body: dict, _parts) -> dict:
        """Online scalar field-index add/remove (reference:
        c_api/gamma_api.h:166,181 AddFieldIndexWithParams/RemoveFieldIndex;
        Go seam gammacb/gamma.go:538,591). The master persists the schema
        change first — so recovered or newly placed replicas build the
        index at load — then fans the op out to EVERY replica of every
        partition: scalar indexes are engine-local structures, not
        replicated state, so each engine builds its own."""
        db, name = body["db_name"], body["space_name"]
        fname = body["field"]
        op = str(body.get("operator_type", "ADD")).upper()
        itype = str(body.get("index_type", "INVERTED")).upper()
        if op == "DROP":
            itype = "NONE"
        elif op != "ADD":
            raise RpcError(400, f"unknown operator_type {op!r}")
        key = f"{PREFIX_SPACE}{db}/{name}"
        # lock covers ONLY the schema read-modify-write: the fan-out below
        # can outlive the lock TTL (sync builds, slow replicas) and does
        # not touch the space record
        token = self._lock_space(db, name)
        try:
            sp = self.store.get(key)
            if sp is None:
                raise RpcError(404, f"space {db}/{name} not found")
            space = Space.from_dict(sp)
            f = next(
                (x for x in space.schema.fields if x.name == fname), None
            )
            if f is None:
                raise RpcError(404, f"field {fname!r} not found")
            if f.data_type is DataType.VECTOR:
                raise RpcError(400, f"{fname!r} is a vector field")
            try:
                f.scalar_index = ScalarIndexType(itype)
            except ValueError:
                raise RpcError(400, f"unknown index_type {itype!r}") from None
            self.store.put(key, space.to_dict())
        finally:
            self._unlock_space(db, name, token)

        # best-effort fan-out: a replica that misses it (dead, or a
        # transient RPC failure) converges anyway — field-index
        # expectations ride every heartbeat response and the PS
        # reconciles its engines against them (_h_register below)
        servers = {s.node_id: s for s in self._alive_servers()}
        acked: list[list[int]] = []
        failed: list[list[int]] = []
        req = {
            "field": fname,
            "index_type": itype,
            "background": bool(body.get("background", True)),
        }
        for part in space.partitions:
            for node_id in part.replicas:
                srv = servers.get(node_id)
                if srv is None:
                    failed.append([part.id, node_id])
                    continue
                try:
                    rpc.call(srv.rpc_addr, "POST", "/ps/field_index",
                             {**req, "partition_id": part.id})
                    acked.append([part.id, node_id])
                except RpcError:
                    failed.append([part.id, node_id])
        return {"field": fname, "index_type": itype,
                "acked": acked, "failed": failed}

    def _field_index_expectations(
        self,
    ) -> tuple[dict[str, dict[str, str]], dict[str, list]]:
        """({partition_id: {field: index_type}}, {partition_id: [scalar
        field dicts]}) over all spaces — the master-side truth PS nodes
        reconcile against each heartbeat (missed /field_index or
        /ps/schema/field fan-outs converge here). Cached on the watch
        revision (bumped by every store mutation) so the per-2s-heartbeat
        cost is a dict lookup, not a space scan."""
        with self._watch_cond:
            rev = self._watch_rev
        cached = getattr(self, "_fidx_cache", None)
        if cached is not None and cached[0] == rev:
            return cached[1], cached[2]
        out: dict[str, dict[str, str]] = {}
        schemas: dict[str, list] = {}
        for sp in self.store.prefix(PREFIX_SPACE).values():
            space = Space.from_dict(sp)
            flags = {
                f.name: f.scalar_index.value
                for f in space.schema.fields
                if f.data_type is not DataType.VECTOR
                and f.scalar_index is not ScalarIndexType.NONE
            }
            scalars = [
                f.to_dict() for f in space.schema.fields
                if f.data_type is not DataType.VECTOR
            ]
            for part in space.partitions:
                out[str(part.id)] = flags
                schemas[str(part.id)] = scalars
        self._fidx_cache = (rev, out, schemas)
        return out, schemas

    def _drop_partitions(self, parts: list[Partition], servers) -> None:
        """Delete partitions on their replicas and trim the ids from the
        server records (a stale partition_ids list would skew the
        least-loaded placement metric forever under retention churn)."""
        by_id = {s.node_id: s for s in servers}
        touched = set()
        for part in parts:
            for node_id in part.replicas:
                srv = by_id.get(node_id)
                if srv is None:
                    continue
                try:
                    rpc.call(srv.rpc_addr, "POST", "/ps/partition/delete",
                             {"partition_id": part.id})
                except RpcError:
                    pass
                if part.id in srv.partition_ids:
                    srv.partition_ids.remove(part.id)
                    touched.add(node_id)
        for node_id in touched:
            self.store.put(f"{PREFIX_SERVER}{node_id}",
                           by_id[node_id].to_dict())

    def _delete_space(self, db: str, name: str) -> dict:
        key = f"{PREFIX_SPACE}{db}/{name}"
        sp = self.store.get(key)
        if sp is None:
            raise RpcError(404, f"space {db}/{name} not found")
        space = Space.from_dict(sp)
        self._drop_partitions(space.partitions, self._alive_servers())
        self.store.delete(key)
        return {"name": name}
