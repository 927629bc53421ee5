"""Pluggable object store for backup/restore.

The reference backs up shards to S3/MinIO (reference:
ps/backup/ps_backup_service.go:14,67 minio client; versioned layout).
Two backends behind one interface:

- `LocalObjectStore` — shared filesystem / NFS;
- `S3ObjectStore` — stdlib-only S3 client (AWS Signature V4 over
  http.client; works against AWS S3 and MinIO). No SDK: the image is
  zero-egress, and the wire protocol is small enough that the four
  operations the backup service needs (PUT/GET object, ListObjectsV2)
  fit in ~100 lines.

Integrity: `put_tree` writes a MANIFEST with per-file CRC32s;
`get_tree` verifies every file against it and fails loudly on mismatch
(reference: ps/backup CRC32 checks).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib

MANIFEST = "MANIFEST.json"
DEDUP_MANIFEST = "MANIFEST.dedup.json"
REFS = "refs.json"


class S3HttpError(IOError):
    """Deliberate S3 error raised AFTER the response body was drained —
    the keep-alive connection is still reusable (unlike transport-level
    OSErrors mid-body, which must drop the connection)."""


def s3_endpoint_host(endpoint: str) -> str:
    """Normalize an endpoint to its host:port — shared by the client and
    the PS allowlist check so both accept/deny identically."""
    return endpoint.split("://", 1)[-1].rstrip("/")


def is_within(root: str, path: str) -> bool:
    """True when `path` resolves inside `root` (commonpath, not string
    prefix: '<root>-evil/x' shares the prefix but not the directory)."""
    root = os.path.abspath(root)
    path = os.path.abspath(path)
    return os.path.commonpath([root, path]) == root


class ObjectStore:
    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def put_file(self, key: str, local_path: str) -> None:
        with open(local_path, "rb") as f:
            self.put_bytes(key, f.read())

    def get_file(self, key: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(self.get_bytes(key))

    def exists(self, key: str) -> bool:
        # abstract on purpose: a get_bytes-based fallback would download
        # whole blobs per probe and read transient store errors as
        # "absent", silently re-uploading (or worse, GC'ing) under
        # faults — every backend must answer existence natively
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    # -- content-addressed dedup tier (reference: ps/backup/
    #    ref_count_manager.go — ref-counted shard files shared across
    #    backup versions) ---------------------------------------------------

    def put_tree_dedup(self, version_prefix: str, local_dir: str,
                       pool_prefix: str, progress=None) -> dict:
        """Upload a tree content-addressed: file payloads land in
        `{pool_prefix}/blobs/{sha256}` (skipped when already present —
        unchanged segments cost nothing across versions), the version
        keeps only a manifest mapping paths to hashes. Ref counts in
        `{pool_prefix}/refs.json` record which versions hold each blob.

        Single-writer discipline: the pool is per-partition and the
        master serialises backup commands per space, so refs read-
        modify-write needs no CAS (matches the reference's per-shard
        manager ownership).
        """
        manifest: dict[str, dict] = {}
        uploads: list[tuple[str, str]] = []
        for dirpath, _dirs, files in os.walk(local_dir):
            for fname in files:
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, local_dir).replace(os.sep, "/")
                h = _sha_file(full)
                manifest[rel] = {"sha256": h,
                                 "size": os.path.getsize(full)}
                uploads.append((h, full))
        # ordering (the ref_count_manager pattern): incref FIRST, then
        # manifest, then blobs. A crash mid-sequence leaves at worst a
        # harmless leaked ref; incref-last would leave a window where a
        # restorable-looking version's shared blobs are unprotected
        # from a concurrent delete's GC.
        seen: set[str] = set()
        for h, _full in uploads:
            seen.add(h)
        refs = self._read_refs(pool_prefix)
        for h in seen:
            holders = refs.setdefault(h, [])
            if version_prefix not in holders:
                holders.append(version_prefix)
        self.put_bytes(f"{pool_prefix}/{REFS}", json.dumps(refs).encode())
        # manifest before blobs: an interrupted backup fails restore
        # loudly (missing blobs), never poses as a complete smaller one
        self.put_bytes(f"{version_prefix}/{DEDUP_MANIFEST}",
                       json.dumps(manifest).encode())
        new = 0
        done: set[str] = set()
        for pos, (h, full) in enumerate(uploads):
            if h not in done:
                done.add(h)
                blob_key = f"{pool_prefix}/blobs/{h}"
                if not self.exists(blob_key):
                    self.put_file(blob_key, full)
                    new += 1
            if progress is not None:
                # progress(files_done, files_total) after each file —
                # the async backup job's per-partition counter
                progress(pos + 1, len(uploads))
        return {"files": len(manifest), "blobs_uploaded": new,
                "blobs_shared": len(seen) - new}

    def get_tree_dedup(self, version_prefix: str, local_dir: str,
                       pool_prefix: str) -> int:
        """Restore a dedup tree, verifying sha256 + size per file."""
        try:
            manifest = json.loads(
                self.get_bytes(f"{version_prefix}/{DEDUP_MANIFEST}")
            )
        except (KeyError, FileNotFoundError) as e:
            raise IOError(
                f"backup at {version_prefix!r} has no dedup manifest "
                f"(incomplete or interrupted backup)"
            ) from e
        os.makedirs(local_dir, exist_ok=True)
        for rel, meta in manifest.items():
            dst = os.path.join(local_dir, rel)
            if os.path.isabs(rel) or not is_within(local_dir, dst):
                raise IOError(f"backup key escapes restore dir: {rel!r}")
            self.get_file(f"{pool_prefix}/blobs/{meta['sha256']}", dst)
            if (
                _sha_file(dst) != meta["sha256"]
                or os.path.getsize(dst) != meta["size"]
            ):
                raise IOError(
                    f"backup integrity check failed for {rel!r}: "
                    f"sha/size mismatch"
                )
        return len(manifest)

    def delete_tree_dedup(self, version_prefix: str,
                          pool_prefix: str) -> dict:
        """Drop a version: decref every pool ref naming it,
        garbage-collect blobs no other version holds (reference:
        ref_count_manager.go decref + cleanup)."""
        # scrub this version from EVERY refs entry, not just the hashes
        # its manifest names: incref runs before the manifest write, so
        # a backup that crashed in that window has refs but no manifest —
        # keying decref on the manifest would pin its blobs (and any it
        # shares with healthy versions) behind a phantom holder forever
        refs = self._read_refs(pool_prefix)
        deleted = 0
        changed = False
        for h in list(refs):
            holders = refs[h]
            if version_prefix in holders:
                holders.remove(version_prefix)
                changed = True
            if not holders:
                # drop the refs entry only once the blob is actually
                # gone: a transient store error must leave the empty
                # entry behind so the NEXT delete call retries the GC
                # instead of orphaning the blob forever
                try:
                    self.delete(f"{pool_prefix}/blobs/{h}")
                    deleted += 1
                except (FileNotFoundError, KeyError):
                    pass  # already gone
                except IOError:
                    continue
                refs.pop(h, None)
                changed = True
        if changed or deleted:
            self.put_bytes(f"{pool_prefix}/{REFS}",
                           json.dumps(refs).encode())
        for key in self.list(version_prefix.rstrip("/") + "/"):
            try:
                self.delete(key)
            except (FileNotFoundError, KeyError, IOError):
                pass
        return {"blobs_deleted": deleted, "blobs_kept": len(refs)}

    def _read_refs(self, pool_prefix: str) -> dict:
        try:
            return json.loads(self.get_bytes(f"{pool_prefix}/{REFS}"))
        except (KeyError, FileNotFoundError, ValueError):
            return {}

    # -- tree transfer with CRC32 manifest (reference: ps/backup crc
    #    integrity + ref-counted shard files) ------------------------------

    def put_tree(self, key_prefix: str, local_dir: str,
                 progress=None) -> int:
        """Upload a directory tree. The manifest (per-file CRC32 + size,
        streamed, never whole-file in memory) is written FIRST: a backup
        interrupted mid-upload then fails restore loudly as incomplete,
        instead of masquerading as a smaller complete one."""
        manifest: dict[str, dict] = {}
        paths: list[tuple[str, str]] = []
        for dirpath, _dirs, files in os.walk(local_dir):
            for fname in files:
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, local_dir).replace(os.sep, "/")
                manifest[rel] = {"crc32": _crc_file(full),
                                 "size": os.path.getsize(full)}
                paths.append((rel, full))
        self.put_bytes(f"{key_prefix}/{MANIFEST}",
                       json.dumps(manifest).encode())
        for pos, (rel, full) in enumerate(paths):
            self.put_file(f"{key_prefix}/{rel}", full)
            if progress is not None:
                progress(pos + 1, len(paths))
        return len(paths)

    def get_tree(self, key_prefix: str, local_dir: str) -> int:
        """Restore a tree, verifying every file's CRC32 against the
        manifest (required); corrupt, missing, or path-escaping entries
        abort the restore rather than quietly loading damaged state."""
        try:
            manifest = json.loads(
                self.get_bytes(f"{key_prefix}/{MANIFEST}")
            )
        except (KeyError, FileNotFoundError) as e:
            raise IOError(
                f"backup at {key_prefix!r} has no manifest (incomplete "
                f"or interrupted backup)"
            ) from e
        pfx = key_prefix.rstrip("/") + "/"  # exact dir, not shard_1 ~ shard_10
        os.makedirs(local_dir, exist_ok=True)
        n = 0
        restored = set()
        for key in self.list(pfx):
            rel = key[len(pfx):] if key.startswith(pfx) else key
            if rel == MANIFEST:
                continue
            dst = os.path.join(local_dir, rel)
            # a hostile/corrupt store must not write outside local_dir
            if os.path.isabs(rel) or not is_within(local_dir, dst):
                raise IOError(f"backup key escapes restore dir: {rel!r}")
            meta = manifest.get(rel)
            if meta is None:
                raise IOError(f"backup file {rel!r} not in manifest")
            self.get_file(key, dst)
            if _crc_file(dst) != meta["crc32"] or \
                    os.path.getsize(dst) != meta["size"]:
                raise IOError(
                    f"backup integrity check failed for {rel!r}: "
                    f"crc/size mismatch"
                )
            restored.add(rel)
            n += 1
        missing = set(manifest) - restored
        if missing:
            raise IOError(f"backup incomplete: missing {sorted(missing)}")
        return n


def _sha_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return h.hexdigest()
            h.update(buf)


def _crc_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def make_object_store(spec: dict | str) -> "ObjectStore":
    """Factory from a backup request's store spec: a plain string is a
    local root; {"type": "s3", ...} builds the S3 backend."""
    if isinstance(spec, str):
        return LocalObjectStore(spec)
    t = spec.get("type", "local")
    if t == "local":
        return LocalObjectStore(spec["root"])
    if t == "s3":
        return S3ObjectStore(
            endpoint=spec["endpoint"], bucket=spec["bucket"],
            access_key=spec.get("access_key", ""),
            secret_key=spec.get("secret_key", ""),
            region=spec.get("region", "us-east-1"),
            prefix=spec.get("prefix", ""),
        )
    raise ValueError(f"unknown object store type {t!r}")


class LocalObjectStore(ObjectStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.abspath(
            os.path.join(os.path.abspath(self.root), key.lstrip("/"))
        )
        if not is_within(self.root, path):
            raise ValueError(f"key escapes store root: {key}")
        return path

    def put_bytes(self, key: str, data: bytes) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dst)

    def get_bytes(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def put_file(self, key: str, local_path: str) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(local_path, dst)

    def get_file(self, key: str, local_path: str) -> None:
        # streamed copy: multi-GB shard files never sit in memory
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        shutil.copyfile(self._path(key), local_path)

    def list(self, prefix: str) -> list[str]:
        base = self._path(prefix)
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                full = os.path.join(dirpath, f)
                out.append(
                    os.path.relpath(full, self.root).replace(os.sep, "/")
                )
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class S3ObjectStore(ObjectStore):
    """Minimal S3 client: PUT/GET object + ListObjectsV2 with AWS
    Signature V4 (reference: ps/backup uses the minio client for the
    same three calls). Stdlib only; path-style addressing so MinIO
    works out of the box."""

    def __init__(self, endpoint: str, bucket: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 prefix: str = ""):
        import threading

        # endpoint: "host:port" or "http(s)://host:port"
        self.secure = endpoint.startswith("https://")
        self.host = s3_endpoint_host(endpoint)
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.prefix = prefix.strip("/")
        # one kept-alive connection per store (a tree transfer would
        # otherwise pay a TCP/TLS handshake per file)
        self._conn = None
        self._conn_lock = threading.Lock()

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    # -- SigV4 (AWS Signature Version 4, the public spec) ----------------

    def _sign(self, method: str, path: str, query: str, payload_hash: str
              ) -> dict:
        import datetime
        import hashlib
        import hmac
        from urllib.parse import quote

        t = datetime.datetime.now(datetime.timezone.utc)
        amz_date = t.strftime("%Y%m%dT%H%M%SZ")
        datestamp = t.strftime("%Y%m%d")
        headers = {
            "host": self.host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed = ";".join(sorted(headers))
        # SigV4 canonicalises query params SORTED by name — real S3
        # rejects construction order (SignatureDoesNotMatch)
        canonical_query = "&".join(sorted(query.split("&"))) if query else ""
        canonical = "\n".join([
            method, quote(path), canonical_query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])

        def hm(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(("AWS4" + self.secret_key).encode(), datestamp)
        k = hm(hm(hm(k, self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        return headers

    def _request(self, method: str, key: str = "", query: str = "",
                 payload: bytes = b"", body_path: str | None = None,
                 stream_to: str | None = None) -> bytes:
        """One signed S3 call. body_path streams the request body from
        disk (two-pass: sha256 then send); stream_to writes the response
        to disk in chunks — multi-GB shard files never sit in memory."""
        import hashlib
        import http.client
        from urllib.parse import quote

        path = f"/{self.bucket}"
        if key:
            path += f"/{key}"
        if body_path is not None:
            h = hashlib.sha256()
            size = 0
            with open(body_path, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    h.update(buf)
                    size += len(buf)
            payload_hash = h.hexdigest()
        else:
            payload_hash = hashlib.sha256(payload).hexdigest()
        headers = self._sign(method, path, query, payload_hash)
        url = quote(path) + (f"?{query}" if query else "")

        def send(conn):
            if body_path is not None:
                headers["Content-Length"] = str(size)
                with open(body_path, "rb") as f:
                    conn.request(method, url, body=f, headers=headers)
            else:
                conn.request(method, url, body=payload or None,
                             headers=headers)
            return conn.getresponse()

        with self._conn_lock:
            cls = http.client.HTTPSConnection if self.secure \
                else http.client.HTTPConnection
            try:
                if self._conn is None:
                    self._conn = cls(self.host, timeout=60)
                resp = send(self._conn)
            except (http.client.HTTPException, OSError):
                # stale keep-alive connection: one fresh retry
                if self._conn is not None:
                    self._conn.close()
                self._conn = cls(self.host, timeout=60)
                resp = send(self._conn)
            try:
                if resp.status == 404:
                    resp.read()  # drained: connection stays reusable
                    raise FileNotFoundError(f"s3://{self.bucket}/{key}")
                if resp.status >= 300:
                    body = resp.read()
                    raise S3HttpError(
                        f"S3 {method} {path}: {resp.status} {body[:200]!r}"
                    )
                if stream_to is not None:
                    os.makedirs(os.path.dirname(stream_to) or ".",
                                exist_ok=True)
                    with open(stream_to, "wb") as out:
                        while True:
                            buf = resp.read(1 << 20)
                            if not buf:
                                break
                            out.write(buf)
                    return b""
                return resp.read()
            except (FileNotFoundError, S3HttpError):
                raise  # drained above: keep-alive intact
            except Exception:
                # anything else (reset mid-body, disk full during the
                # streamed write, ...) leaves an undrained response
                # that would poison keep-alive: drop the connection
                self._conn.close()
                self._conn = None
                raise

    # -- ObjectStore interface -------------------------------------------

    def put_bytes(self, key: str, data: bytes) -> None:
        self._request("PUT", self._key(key), payload=data)

    def get_bytes(self, key: str) -> bytes:
        return self._request("GET", self._key(key))

    def put_file(self, key: str, local_path: str) -> None:
        self._request("PUT", self._key(key), body_path=local_path)

    def get_file(self, key: str, local_path: str) -> None:
        self._request("GET", self._key(key), stream_to=local_path)

    def exists(self, key: str) -> bool:
        try:
            self._request("HEAD", self._key(key))
            return True
        except FileNotFoundError:
            return False

    def delete(self, key: str) -> None:
        try:
            self._request("DELETE", self._key(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str) -> list[str]:
        import html
        import re
        from urllib.parse import quote

        full_prefix = self._key(prefix)
        out: list[str] = []
        token = ""
        while True:
            query = f"list-type=2&prefix={quote(full_prefix, safe='')}"
            if token:
                query += f"&continuation-token={quote(token, safe='')}"
            body = self._request("GET", "", query=query).decode()
            # keys ride XML-escaped (&amp; etc.); unescape or keys with
            # '&'/'<' silently mismatch the manifest on restore
            out.extend(
                html.unescape(k)
                for k in re.findall(r"<Key>([^<]+)</Key>", body)
            )
            m = re.search(
                r"<NextContinuationToken>([^<]+)</NextContinuationToken>",
                body,
            )
            if not m:
                break
            token = html.unescape(m.group(1))
        strip = (self.prefix + "/") if self.prefix else ""
        return sorted(
            k[len(strip):] if strip and k.startswith(strip) else k
            for k in out
        )
