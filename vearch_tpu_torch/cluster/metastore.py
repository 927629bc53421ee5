"""Cluster metadata store: KV + watches + leases + sequences.

TPU-native stand-in for the reference's embedded etcd (reference:
internal/master/server.go:89 embedded etcd; client/master_cache.go watch
-driven caches; master/store/distlock.go). Same primitives the reference
leans on — prefix watch, lease-with-TTL liveness, atomic sequences,
mutex.

Replication: every mutation funnels through `_mutate`, which either
applies directly (single-master mode) or hands the op to a `proposer`
(the master's metadata raft group — the analogue of etcd's raft).
`apply_op` is the deterministic state machine executed on every master
replica in log order; watches fire on every replica so watch-driven
caches stay fresh cluster-wide. Leases and locks are deliberately
leader-local (like etcd, lease keepalive is leader state; a new leader
re-grants leases for persisted keys).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable


class MetaStore:
    def __init__(self, persist_path: str | None = None):
        self._kv: dict[str, Any] = {}
        self._lock = threading.RLock()
        self._watches: list[tuple[str, Callable[[str, str, Any], None]]] = []
        self._leases: dict[int, tuple[float, list[str]]] = {}  # id -> (expiry, keys)
        self._next_lease = 1
        self._locks: dict[str, dict] = {}  # leader-local mutex table
        self._persist_path = persist_path
        # when set, mutations are proposed to the metadata log instead
        # of applied locally; the log's apply calls apply_op everywhere
        self.proposer: Callable[[dict], Any] | None = None
        self.applied_index = 0  # maintained by the replicated master
        if persist_path:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            if os.path.exists(persist_path):
                with open(persist_path) as f:
                    snap = json.load(f)
                # legacy snapshots are the bare kv dict
                if "kv" in snap and isinstance(snap.get("kv"), dict):
                    self._kv = snap["kv"]
                    self.applied_index = int(snap.get("applied", 0))
                else:
                    self._kv = snap

    # -- mutation funnel ------------------------------------------------------

    def _mutate(self, op: dict) -> Any:
        if self.proposer is not None:
            return self.proposer(op)
        return self.apply_op(op)

    def apply_op(self, op: dict) -> Any:
        """Deterministic state machine (runs on every master replica)."""
        t = op.get("t") or op.get("type")  # raft election no-ops use "type"
        if t == "noop":
            return None
        if t == "put":
            return self._do_put(op["key"], op["value"])
        if t == "delete":
            return self._do_delete(op["key"])
        if t == "next_id":
            with self._lock:
                nxt = int(self._kv.get(op["key"], 0)) + 1
                self._kv[op["key"]] = nxt
                self._persist()
                return nxt
        if t == "cas":
            with self._lock:
                if self._kv.get(op["key"]) != op["expect"]:
                    return False
                self._kv[op["key"]] = op["value"]
                self._persist()
                return True
        raise ValueError(f"unknown metastore op {t!r}")

    def _do_put(self, key: str, value: Any) -> None:
        with self._lock:
            self._kv[key] = value
            self._persist()
            watchers = [(p, cb) for p, cb in self._watches
                        if key.startswith(p)]
        for _, cb in watchers:
            cb("PUT", key, value)

    def _do_delete(self, key: str) -> bool:
        with self._lock:
            existed = key in self._kv
            self._kv.pop(key, None)
            self._persist()
            watchers = [(p, cb) for p, cb in self._watches
                        if key.startswith(p)]
        if existed:
            for _, cb in watchers:
                cb("DELETE", key, None)
        return existed

    # -- KV ------------------------------------------------------------------

    def put(self, key: str, value: Any, lease: int | None = None) -> None:
        self._mutate({"t": "put", "key": key, "value": value})
        if lease is not None:
            with self._lock:
                if lease in self._leases:
                    self._leases[lease][1].append(key)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._kv.get(key, default)

    def delete(self, key: str) -> bool:
        return bool(self._mutate({"t": "delete", "key": key}))

    def prefix(self, prefix: str) -> dict[str, Any]:
        with self._lock:
            return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    def cas(self, key: str, expect: Any, value: Any) -> bool:
        """Compare-and-swap (reference: etcd STM transactions)."""
        return bool(self._mutate(
            {"t": "cas", "key": key, "expect": expect, "value": value}
        ))

    # -- watches (reference: client/master_cache.go:414) ---------------------

    def watch_prefix(self, prefix: str, cb: Callable[[str, str, Any], None]) -> None:
        with self._lock:
            self._watches.append((prefix, cb))

    # -- sequences (reference: etcd sequence for space/partition/node ids) ---

    def next_id(self, seq_key: str) -> int:
        return int(self._mutate({"t": "next_id", "key": seq_key}))

    # -- leases (leader-local; reference: etcd leases are leader state) ------

    def grant_lease(self, ttl_s: float) -> int:
        with self._lock:
            lease = self._next_lease
            self._next_lease += 1
            self._leases[lease] = (time.monotonic() + ttl_s, [])
            return lease

    def revoke_lease(self, lease: int) -> None:
        """Drop a lease WITHOUT deleting its keys (used when a new lease
        supersedes it — e.g. re-adoption after a leader change; letting
        the stale lease expire would delete keys the new lease owns)."""
        with self._lock:
            self._leases.pop(lease, None)

    def keepalive(self, lease: int, ttl_s: float) -> bool:
        with self._lock:
            if lease not in self._leases:
                return False
            self._leases[lease] = (time.monotonic() + ttl_s, self._leases[lease][1])
            return True

    def expire_leases(self) -> list[str]:
        """Drop expired leases; returns the keys deleted (the master's
        failure-detection tick — reference: lease expiry fires the
        server-watch DELETE, master_cache.go:963). The deletions
        replicate through the log like any other mutation."""
        now = time.monotonic()
        with self._lock:
            dead = [lid for lid, (exp, _) in self._leases.items() if exp < now]
            doomed: list[str] = []
            for lid in dead:
                doomed.extend(self._leases.pop(lid)[1])
        for key in doomed:
            self.delete(key)
        return doomed

    # -- distributed lock (leader-local: only the leader executes
    #    mutating handlers; reference: master/store/distlock.go) ------------

    def try_lock(self, name: str, owner: str, ttl_s: float = 30.0) -> bool:
        with self._lock:
            cur = self._locks.get(name)
            if cur is not None and cur["expiry"] > time.monotonic() \
                    and cur["owner"] != owner:
                return False
            self._locks[name] = {"owner": owner,
                                 "expiry": time.monotonic() + ttl_s}
            return True

    def unlock(self, name: str, owner: str) -> None:
        with self._lock:
            cur = self._locks.get(name)
            if cur is not None and cur["owner"] == owner:
                self._locks.pop(name, None)

    def clean_expired_locks(self) -> tuple[list[str], list[str]]:
        """(cleaned, still-held) lock names. Runs under the store lock so
        the sweep cannot race a concurrent try_lock re-acquiring a name
        it just judged expired."""
        with self._lock:
            now = time.monotonic()
            cleaned = [n for n, c in self._locks.items()
                       if c["expiry"] <= now]
            for n in cleaned:
                self._locks.pop(n, None)
            return cleaned, sorted(self._locks)

    # -- snapshots (replicated mode: checkpoint + log truncation) ------------

    def snapshot_bytes(self) -> bytes:
        with self._lock:
            return json.dumps(
                {"kv": self._kv, "applied": self.applied_index}
            ).encode()

    def install_snapshot(self, data: bytes) -> None:
        snap = json.loads(data)
        with self._lock:
            self._kv = snap["kv"]
            self.applied_index = int(snap.get("applied", 0))
            self._persist()

    def _persist(self) -> None:
        if self._persist_path:
            tmp = self._persist_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"kv": self._kv, "applied": self.applied_index}, f)
            os.replace(tmp, self._persist_path)
