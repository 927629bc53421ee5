"""Cluster doctor: one fan-out, one report, one exit code.

``python -m vearch_tpu_torch doctor --master HOST:PORT`` asks the master for
the topology, then visits every PS and router to collect ``/metrics``,
``/ps/stats``, ``/debug/slowlog``, ``/debug/compiles``,
``/router/stats`` and ``/cluster/jobs``, folds everything into a
single JSON report with a human summary, and runs the standing
invariant checks:

- ``hbm_drift``          no PS reports footprint-model drift
- ``post_warmup_compiles`` no serving-path compile after warmup
- ``cardinality_ceiling``  every /metrics page stays under the series
                           ceiling the cardinality soak enforces in CI
- ``cluster_health``       the master rollup is not red
- ``slo_burn``             no space with a declared SLO is fast-burning
                           its error budget (router burn-rate windows)
- ``usage_conservation``   every PS's per-tenant meters sum exactly to
                           its accountant totals (docs/ACCOUNTING.md)
- ``search_quality``       no space's shadow-sampled recall sits
                           statistically under its declared floor, and
                           no partition's index-health drift gauges say
                           retrain (docs/QUALITY.md)
- ``obs_docs``             docs/OBSERVABILITY.md matches the source
                           (skipped when no source tree is present)

Exit 0 when every check passes; exit 1 with the violations named.
Usable both as an operator tool against a live deployment and as a
tier-1 smoke test against a 2-node standalone cluster.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any

from vearch_tpu_torch.cluster import rpc

#: per-page series ceiling — keep in lockstep with the cardinality
#: soak's assert (tests/test_metrics_cardinality.py)
SERIES_CEILING = 600


def _series_count(metrics_text: str) -> int:
    return sum(
        1 for ln in metrics_text.splitlines()
        if ln and not ln.startswith("#")
    )


def _scrape(addr: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(
        f"http://{addr}/metrics", timeout=timeout
    ) as r:
        return r.read().decode()


def _get(addr: str, path: str, auth: tuple[str, str] | None) -> Any:
    try:
        return rpc.call(addr, "GET", path, auth=auth)
    except Exception as e:  # unreachable node IS a finding, not a crash
        return {"_error": f"{type(e).__name__}: {e}"}


def collect(
    master_addr: str, auth: tuple[str, str] | None = None
) -> dict[str, Any]:
    """Fan out to every node; return the raw evidence report."""
    report: dict[str, Any] = {"master": master_addr}
    report["health"] = _get(master_addr, "/cluster/health", auth)
    report["jobs"] = _get(master_addr, "/cluster/jobs", auth)
    servers = _get(master_addr, "/servers", auth)
    routers = _get(master_addr, "/routers", auth)
    report["servers"] = []
    for srv in (servers.get("servers") or []):
        addr = srv.get("rpc_addr")
        entry: dict[str, Any] = {
            "node_id": srv.get("node_id"), "addr": addr,
        }
        entry["stats"] = _get(addr, "/ps/stats", auth)
        entry["compiles"] = _get(addr, "/debug/compiles", auth)
        slowlog = _get(addr, "/debug/slowlog", auth)
        entries = (
            slowlog.get("entries") if isinstance(slowlog, dict) else None
        ) or []
        entry["slowlog_len"] = len(entries)
        # recent span heads: enough to correlate a slow request with
        # its trace without shipping whole span trees in the report
        entry["span_heads"] = [
            {"trace_id": e.get("trace_id"), "op": e.get("op"),
             "elapsed_ms": e.get("elapsed_ms")}
            for e in entries[-5:]
        ]
        try:
            entry["metrics_series"] = _series_count(_scrape(addr))
        except Exception as e:
            entry["metrics_series"] = None
            entry["metrics_error"] = str(e)
        report["servers"].append(entry)
    report["routers"] = []
    for rt in (routers.get("routers") or []):
        addr = rt.get("addr")
        entry = {"addr": addr}
        entry["stats"] = _get(addr, "/router/stats", auth)
        try:
            entry["metrics_series"] = _series_count(_scrape(addr))
        except Exception as e:
            entry["metrics_series"] = None
            entry["metrics_error"] = str(e)
        report["routers"].append(entry)
    try:
        report["master_metrics_series"] = _series_count(
            _scrape(master_addr)
        )
    except Exception as e:
        report["master_metrics_series"] = None
        report["master_metrics_error"] = str(e)
    return report


def _check_obs_docs() -> tuple[bool | None, str]:
    """VL401 coverage from the installed source tree; (None, reason)
    when the tree or docs are not available (e.g. doctor run from a
    bare wheel against a remote cluster)."""
    import os

    from vearch_tpu_torch.tools.lint import rules_obs

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_root)
    doc = os.path.join(repo_root, "docs", "OBSERVABILITY.md")
    if not os.path.exists(doc):
        return None, "docs/OBSERVABILITY.md not present; skipped"
    failures = rules_obs.drift_failures_over(
        *rules_obs.source_names(pkg_root), rules_obs.doc_paths()
    )
    if failures:
        return False, "; ".join(failures[:5])
    return True, "docs match source"


_LINT_CLEAN_MEMO: tuple[bool | None, str] | None = None


def _check_lint_clean() -> tuple[bool | None, str]:
    """The full vearch-lint suite — including the interprocedural
    VL5xx serving-path/lock-graph proofs — run in-process over the
    installed source tree. (None, reason) when the tree is not
    available (doctor from a bare wheel against a remote cluster).
    Memoized for the process: doctor can run many times per session
    and the whole-package scan costs seconds; the source tree does not
    change under a running process."""
    global _LINT_CLEAN_MEMO
    if _LINT_CLEAN_MEMO is not None:
        return _LINT_CLEAN_MEMO
    import os

    from vearch_tpu_torch.tools.lint import (
        Allowlist, default_allowlist_path, run_paths,
    )

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(pkg_root, "tools", "lint")):
        return None, "source tree not present; skipped"
    findings = run_paths(
        [pkg_root], allowlist=Allowlist(default_allowlist_path()))
    hard = [f for f in findings if not f.suppressed]
    if hard:
        out = (False, "; ".join(
            f"{f.rule}[{f.tag}] {f.path}:{f.line}" for f in hard[:5]))
    else:
        allowed = sum(1 for f in findings if f.suppressed)
        out = (True, f"0 hard finding(s), {allowed} reason-waived")
    _LINT_CLEAN_MEMO = out
    return out


def run_checks(report: dict[str, Any]) -> list[dict[str, Any]]:
    """Evaluate the standing invariants over a collected report."""
    checks: list[dict[str, Any]] = []

    drifted = []
    for srv in report.get("servers", []):
        samp = (srv.get("stats") or {}).get("device_sampler") or {}
        if samp.get("drift"):
            drifted.append(
                f"node {srv.get('node_id')} "
                f"drift_bytes={samp.get('drift_bytes')}"
            )
    checks.append({
        "name": "hbm_drift", "ok": not drifted,
        "detail": ("; ".join(drifted) if drifted
                   else "measured HBM within model tolerance"),
    })

    compiled = []
    for srv in report.get("servers", []):
        comp = srv.get("compiles") or {}
        total = comp.get("total") or 0
        if total:
            paths = sorted((comp.get("counts") or {}).keys())
            compiled.append(
                f"node {srv.get('node_id')}: {total} "
                f"post-warmup compile(s) on {', '.join(paths)}"
            )
    checks.append({
        "name": "post_warmup_compiles", "ok": not compiled,
        "detail": ("; ".join(compiled) if compiled
                   else "zero serving-path compiles after warmup"),
    })

    over = []
    pages = [("master", report.get("master_metrics_series"))]
    pages += [(f"ps:{s.get('node_id')}", s.get("metrics_series"))
              for s in report.get("servers", [])]
    pages += [(f"router:{r.get('addr')}", r.get("metrics_series"))
              for r in report.get("routers", [])]
    for who, n in pages:
        if n is not None and n > SERIES_CEILING:
            over.append(f"{who}: {n} series > {SERIES_CEILING}")
    checks.append({
        "name": "cardinality_ceiling", "ok": not over,
        "detail": ("; ".join(over) if over
                   else f"all pages under {SERIES_CEILING} series"),
    })

    status = (report.get("health") or {}).get("status")
    checks.append({
        "name": "cluster_health", "ok": status in ("green", "yellow"),
        "detail": f"master rollup is {status!r}",
    })

    # sustained overload shedding: a few sheds are admission control
    # doing its job; a shed RATE above 10% of admitted traffic means
    # the cluster is turning clients away faster than it serves them —
    # capacity or limit tuning needed, not backoff
    shedding = []
    for srv in report.get("servers", []):
        adm = (srv.get("stats") or {}).get("admission") or {}
        shed = int(adm.get("shed_total") or 0)
        admitted = int(adm.get("admitted_total") or 0)
        if shed and shed > 0.10 * max(1, admitted):
            shedding.append(
                f"node {srv.get('node_id')}: {shed} shed vs "
                f"{admitted} admitted "
                f"(queue_limit={adm.get('queue_limit')})"
            )
    checks.append({
        "name": "shed_rate", "ok": not shedding,
        "detail": ("; ".join(shedding) if shedding
                   else "admission shed rate within bounds"),
    })

    # prefetch effectiveness: a disk-tier partition with prefetch on
    # and real traffic should be landing most lookups on pinned or
    # prefetch-confirmed slabs — a low pin+prefetch hit share means the
    # predictor is thrashing (transfers on the critical path) and the
    # operator should raise cache_mb/pin_slots or disable prefetch
    thrashing = []
    observed = 0
    for srv in report.get("servers", []):
        parts = (srv.get("stats") or {}).get("partitions") or {}
        for pid, part in parts.items():
            fields = ((part.get("tiering") or {}).get("fields") or {})
            for fname, tier in fields.items():
                hbm = tier.get("hbm") or {}
                pf = tier.get("prefetch") or {}
                lookups = int(hbm.get("hits") or 0) + int(
                    hbm.get("misses") or 0
                )
                if not pf.get("enabled") or lookups < 512:
                    continue
                observed += 1
                served = int(hbm.get("pin_hits") or 0) + int(
                    hbm.get("prefetch_hits") or 0
                )
                if served < 0.5 * lookups:
                    thrashing.append(
                        f"node {srv.get('node_id')} partition {pid} "
                        f"field {fname}: {served}/{lookups} "
                        f"pin+prefetch hits"
                    )
    checks.append({
        "name": "prefetch_effectiveness", "ok": not thrashing,
        "detail": ("; ".join(thrashing) if thrashing
                   else (f"{observed} disk-tier field(s) serving from "
                         f"pinned/prefetched slabs" if observed
                         else "no disk-tier traffic to judge")),
    })

    # shape-bucket padding waste: a little padding is the price of a
    # bounded compiled-program universe; sustained waste above 50% of
    # padded rows means the traffic's natural batch sizes sit just past
    # tier boundaries — the operator should revisit the bucket grid or
    # raise batch_delay_ms so buckets fill before dispatch
    wasteful = []
    judged = 0
    for srv in report.get("servers", []):
        parts = (srv.get("stats") or {}).get("partitions") or {}
        for pid, part in parts.items():
            sched = part.get("scheduler") or {}
            padded = int(sched.get("pad_padded_rows") or 0)
            if padded < 512:  # not enough traffic to judge
                continue
            judged += 1
            real = int(sched.get("pad_real_rows") or 0)
            if padded - real > 0.5 * padded:
                wasteful.append(
                    f"node {srv.get('node_id')} partition {pid}: "
                    f"{padded - real}/{padded} padded rows wasted "
                    f"({sched.get('padding_waste_pct')}%)"
                )
    checks.append({
        "name": "batch_padding_waste", "ok": not wasteful,
        "detail": ("; ".join(wasteful) if wasteful
                   else (f"{judged} partition(s) under 50% padding waste"
                         if judged
                         else "no bucketed traffic to judge")),
    })

    # per-space SLO burn: a space whose fast (5-minute) window burns
    # its declared error budget at page rate is a tenant-visible
    # incident — the check names the space and its burn multiple so
    # the operator knows WHO is out of budget, not just that someone is
    burning = []
    scored = 0
    for rt in report.get("routers", []):
        slo = ((rt.get("stats") or {}).get("slo") or {})
        for space, rec in slo.items():
            if not isinstance(rec, dict):
                continue
            scored += 1
            if rec.get("fast_burn"):
                burning.append(
                    f"{space} burning {rec.get('burn_fast')}x its error "
                    f"budget (router {rt.get('addr')}, "
                    f"objective {rec.get('objective')})"
                )
    checks.append({
        "name": "slo_burn", "ok": not burning,
        "detail": ("; ".join(burning) if burning
                   else (f"{scored} declared SLO(s) inside budget"
                         if scored else "no spaces declare an SLO")),
    })

    # per-tenant meter conservation: the accountant increments space
    # and total under one lock, so any mismatch is a billing bug, not
    # load noise — exact equality is the contract
    leaks = []
    for srv in report.get("servers", []):
        usage = (srv.get("stats") or {}).get("usage") or {}
        totals = usage.get("totals") or {}
        spaces_u = usage.get("spaces") or {}
        for meter, total in totals.items():
            summed = sum(int((m or {}).get(meter, 0))
                         for m in spaces_u.values())
            if summed != int(total):
                leaks.append(
                    f"node {srv.get('node_id')} meter {meter}: "
                    f"sum(spaces)={summed} != total={total}"
                )
    checks.append({
        "name": "usage_conservation", "ok": not leaks,
        "detail": ("; ".join(leaks) if leaks
                   else "per-space meters reconcile to totals exactly"),
    })

    # search-quality truth: a recall-floor breach means the cluster is
    # serving statistically-wrong answers with green replication; a
    # needs_retrain verdict means the index structure has drifted off
    # its train-time baseline. Both are actionable by name.
    bad_quality = []
    sampled_spaces = 0
    for srv in report.get("servers", []):
        q = (srv.get("stats") or {}).get("quality") or {}
        for space, rec in (q.get("recall") or {}).items():
            sampled_spaces += 1
            if rec.get("breach"):
                worst = min(
                    (t.get("estimate") for t in
                     (rec.get("recall") or {}).values()
                     if t.get("estimate") is not None),
                    default=None,
                )
                bad_quality.append(
                    f"node {srv.get('node_id')} space {space}: recall "
                    f"{worst} under floor {rec.get('floor')}"
                )
        for pid, h in (q.get("health") or {}).items():
            if h.get("needs_retrain"):
                bad_quality.append(
                    f"node {srv.get('node_id')} partition {pid} needs "
                    f"retrain: {'; '.join(h.get('reasons') or [])}"
                )
    checks.append({
        "name": "search_quality", "ok": not bad_quality,
        "detail": ("; ".join(bad_quality) if bad_quality
                   else (f"{sampled_spaces} sampled space(s) above "
                         f"floor, no retrain hints" if sampled_spaces
                         else "no shadow samples to judge")),
    })

    try:
        ok, detail = _check_obs_docs()
    except Exception as e:
        ok, detail = None, f"obs-docs check unavailable: {e}"
    checks.append({
        "name": "obs_docs",
        "ok": True if ok is None else ok,
        "skipped": ok is None,
        "detail": detail,
    })

    try:
        ok, detail = _check_lint_clean()
    except Exception as e:
        ok, detail = None, f"lint check unavailable: {e}"
    checks.append({
        "name": "lint_clean",
        "ok": True if ok is None else ok,
        "skipped": ok is None,
        "detail": detail,
    })
    return checks


def format_report(report: dict[str, Any]) -> str:
    """Human summary: the few lines an operator reads first."""
    lines = []
    health = report.get("health") or {}
    lines.append(
        f"cluster {report.get('master')}: "
        f"health={health.get('status')} "
        f"spaces={len(health.get('spaces') or [])} "
        f"ps_nodes={len(report.get('servers') or [])} "
        f"routers={len(report.get('routers') or [])}"
    )
    for srv in report.get("servers", []):
        stats = srv.get("stats") or {}
        samp = stats.get("device_sampler") or {}
        comp = srv.get("compiles") or {}
        lines.append(
            f"  ps {srv.get('node_id')} @ {srv.get('addr')}: "
            f"partitions={len(stats.get('partitions') or {})} "
            f"hbm_drift={'YES' if samp.get('drift') else 'no'} "
            f"post_warmup_compiles={comp.get('total') or 0} "
            f"slowlog={srv.get('slowlog_len')} "
            f"series={srv.get('metrics_series')}"
        )
    for rt in report.get("routers", []):
        lines.append(
            f"  router @ {rt.get('addr')}: "
            f"series={rt.get('metrics_series')}"
        )
    for chk in report.get("checks", []):
        mark = ("SKIP" if chk.get("skipped")
                else "ok" if chk["ok"] else "FAIL")
        lines.append(f"  [{mark:4}] {chk['name']}: {chk['detail']}")
    violations = report.get("violations") or []
    lines.append(
        "doctor: " + (
            f"{len(violations)} violation(s): "
            + ", ".join(v["name"] for v in violations)
            if violations else "all checks passed"
        )
    )
    return "\n".join(lines)


def run(
    master_addr: str,
    auth: tuple[str, str] | None = None,
) -> tuple[dict[str, Any], int]:
    """Collect + check. Returns (report, exit_code)."""
    report = collect(master_addr, auth=auth)
    checks = run_checks(report)
    report["checks"] = checks
    report["violations"] = [
        c for c in checks if not c["ok"] and not c.get("skipped")
    ]
    return report, (1 if report["violations"] else 0)


def main(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m vearch_tpu_torch doctor",
        description="collect cluster evidence and check the standing "
                    "runtime invariants",
    )
    p.add_argument("--master", required=True, help="master HOST:PORT")
    p.add_argument("--user", default=None)
    p.add_argument("--password", default=None)
    p.add_argument("--json", action="store_true",
                   help="emit the full JSON report instead of the "
                        "human summary")
    args = p.parse_args(argv)
    auth = (
        (args.user, args.password)
        if args.user is not None and args.password is not None else None
    )
    report, code = run(args.master, auth=auth)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_report(report))
    return code
