"""Per-partition write-ahead log.

TPU-native analogue of the reference's raft WAL (reference:
internal/ps/storage/raftstore/store.go:124 wal storage under the
partition path; tiglabs raft log semantics). The log is the durability
and replication substrate: every write is fsync'd here before it is
acked, replayed on recovery, shipped to followers, and truncated behind
the periodic flush (store_raft_job.go:40).

On-disk format, one file per partition (`wal.log`):
    [u32 len][u32 crc32(payload)][payload json]
Recovery stops at the first short/corrupt record (torn tail from a
crash) and truncates the file there. A sidecar `wal.meta.json`
(tmp+rename atomic) records first_index / term / commit_index.

The port's copy of vearch_tpu/cluster/wal.py, with one departure for
raft.py's: the log keeps each entry's payload size, and `entries_from`
can bound a batch by those bytes.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any

from vearch_tpu_torch.cluster.metrics import internal_error
from vearch_tpu_torch.tools import lockcheck

_HDR = struct.Struct("<II")


@lockcheck.guarded
class Wal:
    # lock discipline (lint VL201 + runtime lockcheck): the in-memory
    # log mirror and its window bounds only mutate under _lock. term/
    # commit_index/voted_for are deliberately absent — they are owner-
    # serialized (RaftNode mutates them under ITS _lock; the WAL only
    # reads them back under its own when persisting meta).
    _guarded_by = {
        "_entries": "_lock",
        "_sizes": "_lock",
        "first_index": "_lock",
        "horizon_term": "_lock",
    }

    def __init__(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        self.path = os.path.join(dirpath, "wal.log")
        self.meta_path = os.path.join(dirpath, "wal.meta.json")
        self._lock = lockcheck.make_lock("wal._lock", reentrant=True)
        # in-memory mirror: entry dicts {"index", "term", "op"} — the log
        # tail is bounded by flush-truncation, so this stays modest
        self._entries: list[dict] = []
        # each entry's payload bytes as logged, in lockstep with
        # _entries: entries_from bounds a batch by them
        self._sizes: list[int] = []
        self.first_index = 1  # index of the first entry retained in log
        # term of the entry at first_index - 1 (the compaction/snapshot
        # horizon). Persisted so a leader can always send a REAL
        # prev_term for appends starting exactly at its horizon — the
        # alternative (matching by index alone) lets a follower keep a
        # divergent uncommitted entry at that index, a Log Matching
        # violation. None = unknown (legacy meta): callers must fall
        # back to snapshot install rather than trust the index.
        self.horizon_term: int | None = 0
        self.term = 0
        self.commit_index = 0
        self.voted_for: int | None = None  # election mode only
        # optional (event, info) sink set by the owner (the PS wires it
        # to /metrics histograms). Same contract as the raft observer:
        # cheap, non-blocking, exceptions swallowed — it fires under the
        # WAL lock on the write path.
        self.observer = None
        self._load_meta()
        self._recover()
        self._fd = open(self.path, "ab")

    # -- meta ----------------------------------------------------------------

    def _load_meta(self) -> None:  # lint: allow[guarded] construction-time, runs before the instance is published
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                m = json.load(f)
            self.first_index = int(m.get("first_index", 1))
            self.term = int(m.get("term", 0))
            self.commit_index = int(m.get("commit_index", 0))
            self.voted_for = m.get("voted_for")
            if "horizon_term" in m:
                ht = m["horizon_term"]
                self.horizon_term = None if ht is None else int(ht)
            else:
                # legacy meta: the horizon term is only knowable when
                # the log was never compacted (horizon = index 0)
                self.horizon_term = 0 if self.first_index == 1 else None

    def save_meta(self, fsync: bool = False) -> None:
        with self._lock:
            tmp = self.meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "first_index": self.first_index,
                    "term": self.term,
                    "commit_index": self.commit_index,
                    "voted_for": self.voted_for,
                    "horizon_term": self.horizon_term,
                }, f)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.meta_path)

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:  # lint: allow[guarded] construction-time, runs before the instance is published
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                ln, crc = _HDR.unpack(hdr)
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    break  # torn tail
                self._entries.append(json.loads(payload))
                self._sizes.append(ln)
                good = f.tell()
        actual = os.path.getsize(self.path)
        if good < actual:
            with open(self.path, "r+b") as f:
                f.truncate(good)
        # drop entries the meta says were already pruned (crash between
        # file rewrite and meta update cannot happen — rewrite updates
        # meta first; but be defensive)
        while self._entries and self._entries[0]["index"] < self.first_index:
            self._entries.pop(0)
            self._sizes.pop(0)
        if self._entries:
            self.first_index = self._entries[0]["index"]

    # -- reads ---------------------------------------------------------------

    @property
    def last_index(self) -> int:
        with self._lock:
            if self._entries:
                return self._entries[-1]["index"]
            return self.first_index - 1

    @property
    def last_term(self) -> int:
        with self._lock:
            return self._entries[-1]["term"] if self._entries else 0

    def get(self, index: int) -> dict | None:
        with self._lock:
            i = index - self.first_index
            if 0 <= i < len(self._entries):
                return self._entries[i]
            return None

    def term_at(self, index: int) -> int | None:
        """Term of the entry at `index`; the persisted horizon term at
        first_index - 1 (which is the 0-sentinel, term 0, for a
        never-compacted log); None when the entry has been truncated
        away (and the horizon term is unknown) or is beyond the end.

        NOTE: index 0 deliberately has NO special case. On a compacted
        log (first_index > 1) an unconditional `term_at(0) == 0` let a
        leader believe it could serve an append anchored at prev=0 —
        but entries 1..first_index-1 are GONE, so the 'entries from 1'
        it would attach actually start at first_index and the follower
        hits an append gap. Returning None forces the snapshot path for
        followers behind the horizon (found by the empty-log master
        joiner)."""
        e = self.get(index)
        if e is not None:
            return int(e["term"])
        with self._lock:
            if index == self.first_index - 1:
                return self.horizon_term
        return None

    def entries_from(self, index: int, max_n: int = 512,
                     max_bytes: int | None = None) -> list[dict]:
        """Up to max_n entries from `index`; with max_bytes, only as many
        as fit in that many logged payload bytes (at least one)."""
        with self._lock:
            i = max(0, index - self.first_index)
            out = self._entries[i : i + max_n]
            if max_bytes is not None:
                total = 0
                for j, size in enumerate(self._sizes[i : i + len(out)]):
                    total += size
                    if total > max_bytes and j > 0:
                        out = out[:j]
                        break
            return list(out)

    # -- writes --------------------------------------------------------------

    def append(self, entries: list[dict], fsync: bool = True) -> None:
        if not entries:
            return
        with self._lock:
            expect = self.last_index + 1
            assert entries[0]["index"] == expect, (
                f"append gap: {entries[0]['index']} != {expect}"
            )
            buf = bytearray()
            sizes = []
            for e in entries:
                payload = json.dumps(e).encode()
                buf += _HDR.pack(len(payload), zlib.crc32(payload))
                buf += payload
                sizes.append(len(payload))
            t0 = time.monotonic()
            self._fd.write(buf)
            self._fd.flush()
            t_fsync = time.monotonic()
            if fsync:
                os.fsync(self._fd.fileno())
            t1 = time.monotonic()
            self._entries.extend(entries)
            self._sizes.extend(sizes)
            obs = self.observer
            if obs is not None:
                try:
                    obs("append", {
                        "entries": len(entries),
                        "bytes": len(buf),
                        "seconds": t1 - t0,
                        "fsync_seconds": t1 - t_fsync if fsync else 0.0,
                    })
                except Exception as e:
                    # the observer is best-effort by contract, but its
                    # failures are counted, never silent
                    internal_error("wal.observer", e)

    def truncate_suffix(self, from_index: int) -> None:
        """Drop entries >= from_index (conflict resolution on a follower
        that diverged from the leader)."""
        with self._lock:
            if from_index > self.last_index:
                return
            keep = max(0, from_index - self.first_index)
            self._entries = self._entries[:keep]
            self._sizes = self._sizes[:keep]
            self._rewrite()

    def truncate_prefix(self, new_first: int) -> None:
        """Drop entries < new_first (log compaction behind a flush —
        reference: store_raft_job.go:40 truncate job)."""
        with self._lock:
            if new_first <= self.first_index:
                return
            # record the term at the NEW horizon before the entry holding
            # it is dropped (None only if new_first - 1 is itself already
            # behind an unknown horizon)
            self.horizon_term = self.term_at(new_first - 1)
            drop = min(new_first - self.first_index, len(self._entries))
            self._entries = self._entries[drop:]
            self._sizes = self._sizes[drop:]
            self.first_index = new_first
            self._rewrite()

    def reset(self, first_index: int,
              horizon_term: int | None = None) -> None:
        """Clear the log entirely (after installing a snapshot at
        first_index - 1). `horizon_term` is the term of the snapshot's
        last included entry; None when the installer doesn't know it
        (subsequent appends at the horizon then require a fresh
        snapshot rather than index-matching)."""
        with self._lock:
            self._entries = []
            self._sizes = []
            self.first_index = first_index
            self.horizon_term = horizon_term
            self._rewrite()

    def _rewrite(self) -> None:
        self._fd.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for e in self._entries:
                payload = json.dumps(e).encode()
                f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self.save_meta(fsync=True)
        self._fd = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            self.save_meta()
            self._fd.close()
