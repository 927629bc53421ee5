"""Elasticity operator CLI: split / migrate / rebalance / drain / plan
/ jobs, a thin REST wrapper over the master's elastic endpoints (see
docs/ELASTICITY.md for the runbook these verbs implement).

Also reachable as verbs of the role launcher:

    python -m vearch_tpu_torch rebalance --master host:port --apply
    python -m vearch_tpu_torch drain 3 --master host:port --apply
    python -m vearch_tpu_torch split --master host:port \
        --db mydb --space items --partition 7
    python -m vearch_tpu_torch migrate --master host:port \
        --partition 7 --to 4
    python -m vearch_tpu_torch plan --master host:port
    python -m vearch_tpu_torch jobs --master host:port [--job split-3]

Mutating verbs return a job id and (unless --no-wait) poll
GET /cluster/jobs/{id} to completion, streaming phase/progress to
stderr the same way backup_cli streams backup jobs.
"""

from __future__ import annotations

import argparse
import json
import sys


def _poll_job(master: str, job_id: str, auth, timeout_s: float) -> dict:
    """Poll one elastic job to a terminal status, painting progress on
    stderr. Transient master errors (leader failover, dropped poll) are
    ridden out; only CONSECUTIVE 404s mean the record is really gone
    (master restarted — the registry is in-memory)."""
    import time as _time

    from vearch_tpu_torch.cluster import rpc

    deadline = _time.monotonic() + timeout_s
    misses = 0
    while True:
        if _time.monotonic() > deadline:
            print(f"\ngave up polling after {int(timeout_s)}s; job may "
                  f"still be running: GET /cluster/jobs/{job_id}",
                  file=sys.stderr)
            raise SystemExit(1)
        try:
            job = rpc.call(master, "GET", f"/cluster/jobs/{job_id}",
                           auth=auth)
            misses = 0
        except rpc.RpcError as e:
            misses = misses + 1 if e.code == 404 else 0
            if e.code == 404 and misses >= 5:
                print(f"\njob record lost ({e.msg}); check "
                      "`elastic_cli jobs` later", file=sys.stderr)
                raise SystemExit(1) from None
            _time.sleep(1.0)
            continue
        d = job.get("detail") or {}
        bits = [job["status"], job.get("phase") or ""]
        if d.get("docs_total"):
            bits.append(f"{d.get('docs_done', 0)}/{d['docs_total']} docs")
        if d.get("lag") is not None:
            bits.append(f"lag={d['lag']}")
        steps = job.get("steps") or []
        if steps:
            done = sum(1 for s in steps if s.get("status") == "done")
            bits.append(f"moves {done}/{len(steps)}")
        print("\r" + " ".join(b for b in bits if b).ljust(60), end="",
              file=sys.stderr, flush=True)
        if job["status"] != "running":
            print(file=sys.stderr)
            return job
        _time.sleep(0.5)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="vearch-tpu-elastic")
    ap.add_argument("command",
                    choices=["split", "migrate", "rebalance", "drain",
                             "plan", "jobs"])
    ap.add_argument("node", nargs="?", default=None,
                    help="drain: the PS node id to empty")
    ap.add_argument("--master", required=True,
                    help="master address(es), comma-separated for a "
                         "multi-master group")
    ap.add_argument("--user", default=None)
    ap.add_argument("--password", default=None)
    ap.add_argument("--db", default=None, help="split: database name")
    ap.add_argument("--space", default=None, help="split: space name")
    ap.add_argument("--partition", type=int, default=None,
                    help="split/migrate: target partition id")
    ap.add_argument("--to", type=int, default=None,
                    help="migrate: destination PS node id")
    ap.add_argument("--from", dest="from_node", type=int, default=None,
                    help="migrate: source PS node id (default: a "
                         "follower replica)")
    ap.add_argument("--node", dest="node_flag", type=int, default=None,
                    help="drain: alternative to the positional node id")
    ap.add_argument("--apply", action="store_true",
                    help="rebalance/drain: execute the plan instead of "
                         "printing it")
    ap.add_argument("--max-moves", type=int, default=4,
                    help="rebalance: cap on replica moves per run")
    ap.add_argument("--job", default=None, help="jobs: one job id")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="job wall-clock budget (server + client poll)")
    ap.add_argument("--no-wait", action="store_true",
                    help="return the job id immediately, don't poll")
    args = ap.parse_args(argv)

    from vearch_tpu_torch.cluster import rpc

    auth = (args.user, args.password) if args.user else None
    try:
        if args.command == "plan":
            out = rpc.call(args.master, "GET", "/cluster/plan", auth=auth)
        elif args.command == "jobs":
            path = "/cluster/jobs" + (f"/{args.job}" if args.job else "")
            out = rpc.call(args.master, "GET", path, auth=auth)
        elif args.command == "split":
            if not (args.db and args.space and args.partition is not None):
                raise SystemExit("split needs --db, --space, --partition")
            out = rpc.call(args.master, "POST", "/partitions/split", {
                "db_name": args.db, "space_name": args.space,
                "partition_id": args.partition,
                "timeout_s": args.timeout,
            }, auth=auth)
        elif args.command == "migrate":
            if args.partition is None or args.to is None:
                raise SystemExit("migrate needs --partition and --to")
            body = {"partition_id": args.partition, "to_node": args.to,
                    "timeout_s": args.timeout}
            if args.from_node is not None:
                body["from_node"] = args.from_node
            out = rpc.call(args.master, "POST", "/partitions/migrate",
                           body, auth=auth)
        elif args.command == "rebalance":
            out = rpc.call(args.master, "POST", "/cluster/rebalance", {
                "apply": args.apply, "max_moves": args.max_moves,
            }, auth=auth)
        else:  # drain
            node = args.node_flag if args.node_flag is not None \
                else args.node
            if node is None:
                raise SystemExit("drain needs a node id: "
                                 "`drain <node>` or --node")
            out = rpc.call(args.master, "POST", "/cluster/drain", {
                "node_id": int(node), "apply": args.apply,
            }, auth=auth)
        job_id = out.get("job_id") if isinstance(out, dict) else None
        if job_id and not args.no_wait:
            out = _poll_job(args.master, job_id, auth, args.timeout + 60.0)
            print(json.dumps(out, indent=2))
            return 0 if out.get("status") == "done" else 1
    except rpc.RpcError as e:
        print(f"error ({e.code}): {e.msg}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
