"""Standalone backup CLI (reference: tools/backup/vearch_backup.go —
a thin REST wrapper over the master's backup API).

Usage:
    python -m vearch_tpu_torch.tools.backup_cli \
        --master host:port --db mydb --space myspace create \
        --store-root /mnt/backups
    python -m vearch_tpu_torch.tools.backup_cli ... list --store-root ...
    python -m vearch_tpu_torch.tools.backup_cli ... restore --version 3 \
        --s3-endpoint minio:9000 --s3-bucket vearch \
        --s3-access-key ak --s3-secret-key sk
"""

from __future__ import annotations

import argparse
import json
import sys


def build_store_spec(args) -> dict:
    if args.s3_endpoint:
        spec: dict = {
            "type": "s3",
            "endpoint": args.s3_endpoint,
            "bucket": args.s3_bucket or "vearch",
            "access_key": args.s3_access_key or "",
            "secret_key": args.s3_secret_key or "",
        }
        if args.s3_region:
            spec["region"] = args.s3_region
        if args.s3_prefix:
            spec["prefix"] = args.s3_prefix
        return {"store": spec}
    if not args.store_root:
        raise SystemExit("need --store-root or --s3-endpoint")
    return {"store_root": args.store_root}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="vearch-tpu-backup")
    ap.add_argument("--master", required=True,
                    help="master address(es), comma-separated for a "
                         "multi-master group")
    ap.add_argument("--db", required=True)
    ap.add_argument("--space", required=True)
    ap.add_argument("--user", default=None)
    ap.add_argument("--password", default=None)
    ap.add_argument("command",
                    choices=["create", "list", "restore", "delete"])
    ap.add_argument("--version", type=int, default=None,
                    help="backup version (restore/delete)")
    ap.add_argument("--store-root", default=None,
                    help="local/NFS object store root")
    ap.add_argument("--s3-endpoint", default=None)
    ap.add_argument("--s3-bucket", default=None)
    ap.add_argument("--s3-access-key", default=None)
    ap.add_argument("--s3-secret-key", default=None)
    ap.add_argument("--s3-region", default=None)
    ap.add_argument("--s3-prefix", default=None)
    ap.add_argument("--sync", action="store_true",
                    help="create: block until the backup finishes "
                         "instead of running it as an async job")
    args = ap.parse_args(argv)

    from vearch_tpu_torch.cluster import rpc

    body = {"command": args.command, **build_store_spec(args)}
    if args.command in ("restore", "delete"):
        if args.version is None:
            raise SystemExit(f"{args.command} needs --version")
        body["version"] = args.version
    if args.command == "create" and not args.sync:
        body["async"] = True
    auth = (args.user, args.password) if args.user else None
    try:
        out = rpc.call(
            args.master, "POST",
            f"/backup/dbs/{args.db}/spaces/{args.space}", body, auth=auth,
        )
        if args.command == "create" and not args.sync:
            # poll the master job to completion, showing per-partition
            # progress (reference: async backup + progress endpoints)
            job_id = out["job_id"]
            import time as _time

            poll_deadline = _time.monotonic() + 3600.0
            misses = 0
            while True:
                if _time.monotonic() > poll_deadline:
                    print("\ngave up polling after 1h; job may still be "
                          f"running: GET /backup/jobs/{job_id}",
                          file=sys.stderr)
                    return 1
                try:
                    job = rpc.call(args.master, "GET",
                                   f"/backup/jobs/{job_id}", auth=auth)
                    misses = 0
                except rpc.RpcError as e:
                    # ride out leader failover / transient network; only
                    # CONSECUTIVE 404s mean the job record is really
                    # gone (master restarted — records are in-memory)
                    misses = misses + 1 if e.code == 404 else 0
                    if e.code == 404 and misses >= 5:
                        print(f"\njob record lost ({e.msg}); the backup "
                              "may still complete — check "
                              "`backup_cli list` later", file=sys.stderr)
                        return 1
                    _time.sleep(1.0)
                    continue
                parts = job["partitions"]
                line = " ".join(
                    f"p{pid}:{p['status']}"
                    + (f"({p['files_done']}/{p['files_total']})"
                       if p.get("files_total") else "")
                    for pid, p in sorted(parts.items())
                )
                print(f"\r{job['status']}: {line}", end="",
                      file=sys.stderr, flush=True)
                if job["status"] != "running":
                    print(file=sys.stderr)
                    break
                _time.sleep(0.5)
            out = job
            if job["status"] == "error":
                print(json.dumps(out, indent=2))
                return 1
    except rpc.RpcError as e:
        print(f"error ({e.code}): {e.msg}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
