"""Role launcher: `python -m vearch_tpu_torch --role master|ps|router|standalone`.

The reference ships one binary that runs any combination of roles by CLI
tag (reference: cmd/vearch/startup.go:87,112-120). Same shape here; each
role blocks until SIGINT.

The port's launcher is vearch_tpu/__main__.py's with one departure: the
partition servers' engines run on `--device` (default: the card; with no
GPU visible a ps or standalone role raises at start). The operator verbs
(`rebalance`, `drain`, `split`, `migrate`, `plan`, `jobs`, `doctor`)
dispatch as the reference's do.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


ELASTIC_VERBS = ("rebalance", "drain", "split", "migrate", "plan", "jobs")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ELASTIC_VERBS:
        # operator verbs (`vearch_tpu_torch rebalance`, `... drain 3`)
        # delegate to the elasticity CLI — same binary, no role daemon
        from vearch_tpu_torch.tools.elastic_cli import main as elastic_main

        return elastic_main(argv)
    if argv and argv[0] == "doctor":
        # cluster doctor: fan out, collect evidence, check the standing
        # runtime invariants, exit non-zero on any violation
        from vearch_tpu_torch.obs.doctor import main as doctor_main

        return doctor_main(argv[1:])

    ap = argparse.ArgumentParser(prog="vearch_tpu_torch")
    ap.add_argument("--role", default="standalone",
                    choices=["master", "ps", "router", "standalone"])
    ap.add_argument("--conf", default=None,
                    help="TOML config file (reference: -conf config.toml)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--master-addr", default=None,
                    help="host:port of the master (ps/router roles)")
    ap.add_argument("--data-dir", default="./vearch_data")
    ap.add_argument("--auth", action="store_true")
    ap.add_argument("--grpc-port", type=int, default=None,
                    help="router only: serve gRPC next to HTTP "
                         "(reference: router rpc_port)")
    ap.add_argument("--root-password", default="secret")
    ap.add_argument("--n-ps", type=int, default=1,
                    help="partition servers in standalone mode")
    ap.add_argument("--node-id", type=int, default=1,
                    help="master only: this replica's id in a "
                         "multi-master metadata raft")
    ap.add_argument("--peers", default=None,
                    help="master only: multimaster peer map, "
                         "'1=host:port,2=host:port,...' (reference: "
                         "embedded-etcd initial-cluster)")
    ap.add_argument("--device", default=None,
                    help="ps/standalone: the torch device of the engines "
                         "(default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from vearch_tpu_torch.utils import log

    if args.conf:
        from vearch_tpu_torch.cluster.config import Config

        cfg = Config.load(args.conf)
        section = getattr(cfg, args.role, {}) if args.role != "standalone" \
            else {}
        args.host = section.get("host", args.host)
        args.port = int(section.get("port", args.port))
        args.master_addr = section.get("master_addr", args.master_addr)
        args.data_dir = cfg.data_dir if args.data_dir == "./vearch_data" \
            else args.data_dir
        args.auth = args.auth or cfg.auth
        args.root_password = cfg.root_password
        # per-role rotating file log + stderr (reference: [global] log
        # dir + level, pkg/log rotating writer)
        log.init(args.role, log_dir=cfg.log_dir_for(args.data_dir),
                 level=cfg.log_level)
    else:
        import os

        log.init(args.role, log_dir=None,
                 level=os.environ.get("VEARCH_LOG_LEVEL", "info"))

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())

    if args.role == "standalone":
        from vearch_tpu_torch.cluster.standalone import StandaloneCluster

        cluster = StandaloneCluster(data_dir=args.data_dir, n_ps=args.n_ps,
                                    ps_kwargs={"device": args.device})
        cluster.start()
        print(f"router: http://{cluster.router_addr}  "
              f"master: http://{cluster.master_addr}", flush=True)
        stop.wait()
        cluster.stop()
        return 0

    if args.role == "master":
        from vearch_tpu_torch.cluster.master import MasterServer

        peers = None
        if args.peers:
            peers = {}
            for part in args.peers.split(","):
                nid, _, addr = part.strip().partition("=")
                peers[int(nid)] = addr
        server = MasterServer(
            host=args.host, port=args.port,
            persist_path=f"{args.data_dir}/meta.json",
            auth=args.auth, root_password=args.root_password,
            node_id=args.node_id, peers=peers,
            meta_dir=args.data_dir if peers else None,
        )
        server.start()
        print(f"master: http://{server.addr}", flush=True)
        stop.wait()
        server.stop()
        return 0

    if args.master_addr is None:
        print("--master-addr required for ps/router roles", file=sys.stderr)
        return 2

    if args.role == "ps":
        from vearch_tpu_torch.cluster.ps import PSServer

        cfg_ps = {}
        cfg_tr = {}
        if args.conf:
            from vearch_tpu_torch.cluster.config import Config

            cfg = Config.load(args.conf)
            cfg_ps = getattr(cfg, "ps", {}) or {}
            cfg_tr = getattr(cfg, "tracer", {}) or {}
        server = PSServer(
            data_dir=args.data_dir, host=args.host, port=args.port,
            master_addr=args.master_addr,
            master_auth=("root", args.root_password) if args.auth else None,
            backup_roots=cfg_ps.get("backup_roots"),
            backup_endpoints=cfg_ps.get("backup_endpoints"),
            trace_collector=cfg_tr.get("collector_endpoint"),
            search_cache_entries=int(
                cfg_ps.get("search_cache_entries", 256)),
            # overload shedding bound (0 disables; runtime-tunable via
            # /ps/engine/config)
            admission_queue_limit=int(
                cfg_ps.get("admission_queue_limit", 0)),
            device=args.device,
        )
        server.start()
        print(f"ps node {server.node_id}: http://{server.addr}", flush=True)
        stop.wait()
        server.stop()
        return 0

    from vearch_tpu_torch.cluster.router import RouterServer

    cfg_rt = {}
    cfg_tr = {}
    if args.conf:
        from vearch_tpu_torch.cluster.config import Config

        cfg = Config.load(args.conf)
        cfg_rt = getattr(cfg, "router", {}) or {}
        cfg_tr = getattr(cfg, "tracer", {}) or {}
    server = RouterServer(
        master_addr=args.master_addr, host=args.host, port=args.port,
        auth=args.auth,
        master_auth=("root", args.root_password) if args.auth else None,
        # reference: [tracer] config block (sampler rate), startup.go:66
        trace_sample=float(cfg_tr.get("sample_rate", 0.0)),
        trace_export=cfg_tr.get("export_path"),
        trace_collector=cfg_tr.get("collector_endpoint"),
        grpc_port=args.grpc_port,
        # fan-out pool size (0 = auto with partition count) and the
        # merged-result cache knobs from the [router] block
        fanout_workers=int(cfg_rt.get("fanout_workers", 0)),
        cache_entries=int(cfg_rt.get("cache_entries", 512)),
        cache_ttl_s=float(cfg_rt.get("cache_ttl_s", 10.0)),
        # tail-latency knobs: adaptive hedged scatter (quantile-derived
        # delay, budget-capped) and least-loaded replica reads
        hedge_quantile=float(cfg_rt.get("hedge_quantile", 0.95)),
        hedge_budget_pct=float(cfg_rt.get("hedge_budget_pct", 10.0)),
        replica_read=bool(cfg_rt.get("replica_read", False)),
    )
    server.start()
    print(f"router: http://{server.addr}", flush=True)
    if server.grpc is not None:
        print(f"router grpc: {server.grpc.addr}", flush=True)
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
