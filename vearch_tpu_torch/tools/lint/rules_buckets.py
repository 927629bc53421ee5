"""Shape-bucket discipline.

VL103 — serving code must not construct batch shapes outside the
declared bucket set. The continuous-batching scheduler's zero-retrace
guarantee (docs/PERF.md Tier 7) rests on every padded dispatch shape
coming from ONE grid: `ops/perf_model.ROW_BUCKETS` x
`FETCH_K_TIERS`. Two failure modes this rule closes:

- a module re-declares its own `*_BUCKETS` / `*_TIERS` literal instead
  of importing the perf model's — the grids drift apart and the
  compiled-program bound silently stops holding;
- the canonical declaration itself changes without the policy pin in
  `tools/lint/config.py` moving with it — tier changes are a perf-model
  event (warmup sets, program-count gates, bench baselines all shift)
  and must be conscious.
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _int_seq(node: ast.AST) -> tuple[int, ...] | None:
    """Evaluate a Tuple/List literal of plain ints; None otherwise."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out: list[int] = []
    for elt in node.elts:
        if isinstance(elt, ast.Constant) and isinstance(elt.value, int) \
                and not isinstance(elt.value, bool):
            out.append(elt.value)
        else:
            return None
    return tuple(out)


def _tier_assigns(ctx: FileContext):
    """Module-level `NAME = (ints...)` where NAME looks like a shape
    tier declaration. Yields (name, values, line)."""
    for node in ctx.tree.body:
        targets: list[ast.AST] = []
        value: ast.AST | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        seq = _int_seq(value)
        if seq is None:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and any(
                t.id.endswith(suf) for suf in config.BUCKET_NAME_SUFFIXES
            ):
                yield t.id, seq, node.lineno


def _check_buckets(ctx: FileContext):
    path = _norm(ctx.path)
    if "/tools/lint/" in path:
        # the lint package IS the policy pin — its copies of the grid
        # are the reference the rule compares against
        return
    if path.endswith(config.BUCKET_DECL_FILE):
        # the canonical declaration: its values must match the policy
        # pin, so a grid change is a conscious two-file edit
        want = {
            "ROW_BUCKETS": tuple(config.BUCKET_ROW_TIERS),
            "FETCH_K_TIERS": tuple(config.BUCKET_FETCH_K_TIERS),
        }
        seen: dict[str, tuple[tuple[int, ...], int]] = {}
        for name, seq, line in _tier_assigns(ctx):
            seen[name] = (seq, line)
        for name, values in want.items():
            if name not in seen:
                yield Finding(
                    "VL103", "bucket-drift", ctx.path, 1,
                    f"canonical shape grid `{name}` missing from the "
                    "perf model — the scheduler's zero-retrace bound "
                    "has no declaration to hold against",
                )
            elif seen[name][0] != values:
                got, line = seen[name]
                ok, reason = ctx.allowed(line, "bucket-drift")
                yield Finding(
                    "VL103", "bucket-drift", ctx.path, line,
                    f"`{name}` = {got} diverges from the lint policy "
                    f"pin {values} (tools/lint/config.py) — tier "
                    "changes must move both or the program-count "
                    "gates drift",
                    suppressed=ok, reason=reason,
                )
        return
    for name, seq, line in _tier_assigns(ctx):
        ok, reason = ctx.allowed(line, "bucket-drift")
        yield Finding(
            "VL103", "bucket-drift", ctx.path, line,
            f"shape-tier literal `{name}` = {seq} declared outside "
            f"{config.BUCKET_DECL_FILE} — serving code must import "
            "the declared bucket grid, not re-declare it",
            suppressed=ok, reason=reason,
        )


register(Rule(
    id="VL103", tag="bucket-drift",
    doc="batch shapes only from the declared perf-model bucket grid",
    check_file=_check_buckets,
))
