"""Elastic data-plane planning: placement, imbalance scoring, and
split/move plan computation.

Pure functions over cluster metadata (entities.Space/Server) and the
heartbeat-fed per-node partition stats — no RPC, no locks, no store —
so the planner is unit-testable standalone and the master's rebalance
endpoints stay thin (reference: the partition admin + placement layer
under internal/master/, which scores PS load from the monitor gauges).

Load model: a partition's *weight* is its reported engine bytes (what
actually pins a PS's memory); its *heat* is the cumulative search +
write counters riding heartbeats. Moves balance weight; splits target
heat concentrated in one partition of a space (a hot partition must be
subdivided before its halves can spread).
"""

from __future__ import annotations

from typing import Iterable, Mapping

from vearch_tpu_torch.cluster.entities import Server, Space
from vearch_tpu_torch.cluster.hashing import MAX_UINT32

__all__ = [
    "place_replicas",
    "imbalance_score",
    "node_loads",
    "compute_plan",
    "split_ranges",
]


def place_replicas(
    space: Space,
    servers: list[Server],
    node_stats: Mapping[int, Mapping[str, Mapping]] | None = None,
) -> list[int]:
    """Pick `space.replica_num` distinct PS nodes for one partition.

    Strict anti-affinity by node: two replicas of one partition NEVER
    co-locate — co-location means one PS failure eats both copies, so
    when fewer distinct alive servers exist than replica_num this
    raises ValueError instead of silently doubling up (the old
    placement crashed with AttributeError *or* co-located, depending on
    pool order).

    Preference order is least-loaded first: reported engine bytes from
    the heartbeat stats, then fewest hosted partitions, then node_id as
    the deterministic tie-break (same inputs -> same placement, so
    placement decisions are reproducible in tests and postmortems).
    The space's label anti-affinity (host/rack/zone) stays a soft
    preference on top, falling back to label collisions when the
    topology is too small — matching the reference's fallback.
    """
    uniq: dict[int, Server] = {}
    for s in servers:
        uniq.setdefault(s.node_id, s)
    if space.replica_num > len(uniq):
        raise ValueError(
            f"cannot place {space.replica_num} replicas on "
            f"{len(uniq)} distinct alive servers without co-locating"
        )
    loads = node_loads(list(uniq.values()), node_stats or {})
    pool = sorted(
        uniq.values(),
        key=lambda s: (loads.get(s.node_id, 0.0),
                       len(s.partition_ids), s.node_id),
    )
    label = space.anti_affinity
    chosen: list[int] = []
    used_labels: set[str] = set()
    for _ in range(space.replica_num):
        pick = None
        if label != "none":
            pick = next(
                (s for s in pool
                 if s.node_id not in chosen
                 and s.labels.get(label, f"~{s.node_id}")
                 not in used_labels),
                None,
            )
        if pick is None:
            pick = next(s for s in pool if s.node_id not in chosen)
        chosen.append(pick.node_id)
        used_labels.add(pick.labels.get(label, f"~{pick.node_id}"))
    return chosen


def node_loads(
    servers: Iterable[Server],
    node_stats: Mapping[int, Mapping[str, Mapping]],
) -> dict[int, float]:
    """Per-node weight: sum of reported engine bytes over the
    partitions each node actually heartbeated. A node with no stats yet
    (freshly joined) weighs 0.0 — exactly what makes it the preferred
    move/placement target."""
    out: dict[int, float] = {}
    for s in servers:
        stats = node_stats.get(s.node_id, {})
        out[s.node_id] = float(sum(
            float(st.get("size_bytes", 0) or 0)
            for st in stats.values()
        ))
    return out


def imbalance_score(loads: Iterable[float]) -> float:
    """(max - min) / mean over per-node loads; 0.0 for degenerate
    inputs (fewer than two nodes, or an all-empty cluster). 0 means
    perfectly even; 1.0 means the spread equals the average load."""
    vals = [float(v) for v in loads]
    if len(vals) < 2:
        return 0.0
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 0.0
    return (max(vals) - min(vals)) / mean


def split_ranges(space: Space, pid: int) -> tuple[int, int, int]:
    """(lo, mid, hi) slot bounds for splitting partition `pid` of a
    slot-sharded space: children cover [lo, mid) and [mid, hi).

    Raises ValueError when the split is structurally impossible: rule
    spaces (groups are keyed by range name, not slot), expanded spaces
    (pre-carve rows live off-slot, so slot-range children would lose
    them), or a slot range already too narrow to subdivide."""
    if space.partition_rule:
        raise ValueError("rule spaces grow via /partitions/rule ADD, "
                         "not slot splits")
    if space.expanded:
        raise ValueError(
            "expanded spaces hold off-slot rows (pre-carve data); a "
            "slot-range split would strand them")
    parts = sorted(space.partitions, key=lambda p: p.slot)
    idx = next((i for i, p in enumerate(parts) if p.id == pid), None)
    if idx is None:
        raise ValueError(f"partition {pid} not in space "
                         f"{space.db_name}/{space.name}")
    lo = parts[idx].slot
    hi = parts[idx + 1].slot if idx + 1 < len(parts) else MAX_UINT32 + 1
    mid = (lo + hi) // 2
    if not lo < mid < hi:
        raise ValueError(
            f"slot range [{lo}, {hi}) of partition {pid} is too "
            f"narrow to split")
    return lo, mid, hi


def compute_plan(
    spaces: list[Space],
    servers: list[Server],
    node_stats: Mapping[int, Mapping[str, Mapping]],
    max_moves: int = 4,
    imbalance_threshold: float = 0.25,
    split_hot_share: float = 0.6,
) -> dict:
    """Compute a rebalance plan: replica moves that level per-node
    weight, plus split suggestions for heat concentrated in single
    partitions. Returns a plain dict the operator endpoints serve
    verbatim:

        {"imbalance": float, "node_loads": {node_id: bytes},
         "moves":  [{partition_id, from_node, to_node, reason}],
         "splits": [{partition_id, db_name, space_name, reason}],
         "needs_retrain": [{partition_id, db_name, space_name,
                            reasons}]}

    Moves are greedy hottest-node -> coldest-node: pick the heaviest
    partition on the most loaded node whose move (a) lands on a node
    not already holding a replica and (b) strictly shrinks the
    hot/cold gap. Deterministic: ties break by partition id and
    node id, so the same inputs always yield the same plan (apply-mode
    reruns and tests depend on that).
    """
    servers = sorted({s.node_id: s for s in servers}.values(),
                     key=lambda s: s.node_id)
    loads = node_loads(servers, node_stats)
    plan: dict = {
        "imbalance": round(imbalance_score(loads.values()), 4),
        "node_loads": {str(n): v for n, v in sorted(loads.items())},
        "moves": [],
        "splits": [],
        "needs_retrain": [],
    }

    # index-health retrain hints: the PS quality monitor's drift
    # verdict (recon error off its train-time baseline, IVF cell
    # imbalance, deleted/unindexed fractions) rides the heartbeat's
    # per-partition "quality" block — surface it next to the placement
    # plan so one endpoint answers "what should the autopilot do".
    # Leader report wins; deterministic order by partition id.
    for sp in sorted(spaces, key=lambda s: (s.db_name, s.name)):
        for p in sorted(sp.partitions, key=lambda p: p.id):
            q = None
            for nid in [p.leader] + [r for r in p.replicas
                                     if r != p.leader]:
                st = node_stats.get(nid, {}).get(str(p.id)) or {}
                if st.get("quality") is not None:
                    q = st["quality"]
                    break
            if q and q.get("needs_retrain"):
                plan["needs_retrain"].append({
                    "partition_id": p.id, "db_name": sp.db_name,
                    "space_name": sp.name,
                    "reasons": list(q.get("reasons") or []),
                })

    # partition weight/replicas index (leader report wins; any replica
    # report is better than nothing)
    weight: dict[int, float] = {}
    replicas: dict[int, list[int]] = {}
    for sp in spaces:
        for p in sp.partitions:
            replicas[p.id] = list(p.replicas)
            best = 0.0
            for nid in p.replicas:
                st = node_stats.get(nid, {}).get(str(p.id))
                if st is not None:
                    v = float(st.get("size_bytes", 0) or 0)
                    best = max(best, v)
            weight[p.id] = best

    if len(servers) >= 2:
        moved: set[int] = set()
        sim = dict(loads)
        for _ in range(max_moves):
            if imbalance_score(sim.values()) <= imbalance_threshold:
                break
            hot = max(sim, key=lambda n: (sim[n], n))
            cold = min(sim, key=lambda n: (sim[n], -n))
            gap = sim[hot] - sim[cold]
            if gap <= 0:
                break
            # heaviest movable partition on the hot node whose weight
            # fits inside the gap (otherwise the move just swaps which
            # node is hot); prefer larger weight, tie-break by id
            candidates = sorted(
                (pid for pid, reps in replicas.items()
                 if hot in reps and cold not in reps
                 and pid not in moved and 0 < weight.get(pid, 0.0) < gap),
                key=lambda pid: (-weight[pid], pid),
            )
            if not candidates:
                break
            pid = candidates[0]
            plan["moves"].append({
                "partition_id": pid, "from_node": hot, "to_node": cold,
                "reason": f"level load: node {hot} carries "
                          f"{int(sim[hot])}B vs node {cold} "
                          f"{int(sim[cold])}B",
            })
            moved.add(pid)
            sim[hot] -= weight[pid]
            sim[cold] += weight[pid]

    # split suggestions: one partition of a space absorbing most of the
    # space's traffic is the signal a move cannot fix — its halves must
    # exist before they can spread
    for sp in spaces:
        if len(sp.partitions) < 1:
            continue
        heat: dict[int, float] = {}
        for p in sp.partitions:
            st = node_stats.get(p.leader, {}).get(str(p.id))
            if st is None:
                continue
            heat[p.id] = float(st.get("searches_total", 0) or 0) + \
                float(st.get("writes_total", 0) or 0)
        total = sum(heat.values())
        if total <= 0:
            continue
        pid, hottest = max(sorted(heat.items()), key=lambda kv: kv[1])
        if hottest / total < split_hot_share:
            continue
        if len(sp.partitions) == 1 and hottest == total and total < 2:
            continue  # a single barely-touched partition is not "hot"
        try:
            split_ranges(sp, pid)
        except ValueError:
            continue  # structurally unsplittable; don't suggest it
        plan["splits"].append({
            "partition_id": pid, "db_name": sp.db_name,
            "space_name": sp.name,
            "reason": f"partition {pid} carries "
                      f"{round(100 * hottest / total)}% of the "
                      f"space's traffic",
        })
    return plan
