"""Search-quality staleness discipline.

VL105 — index-mutating paths must call the quality staleness hook.
The shadow recall sampler (obs/quality.py, docs/QUALITY.md) queues
served results and later scores them against fresh exact ground truth.
A function in the quality-wired files (`tools/lint/config.py:
VL105_QUALITY_FILES`) that calls an index mutator — an attribute call
named in `VL105_INDEX_MUTATORS`, i.e. an engine build/rebuild that
replaces the serving snapshot wholesale — without also calling the
monitor's `note_index_mutation` hook leaves the estimators comparing
fresh truth against pre-mutation serving behaviour: the recall gauge
reports phantom loss (or worse, hides a real one behind a reset that
never happened).

Doc-level writes (upsert/delete through the replicated log) are out of
scope: every queued shadow job pins the engine `data_version` it was
served at and is dropped as `stale` if the corpus moved — the hook is
for *structural* replacement, where the version bump alone cannot say
"the quantizers changed too". A genuinely estimator-neutral mutator
call carries an inline ``allow[quality-staleness]`` with the reason.
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _called_attrs(func: ast.AST) -> set[str]:
    """Attribute names invoked anywhere in the function body
    (`eng.build_index()` -> `build_index`), plus bare call names."""
    out: set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            out.add(node.func.attr)
        elif isinstance(node.func, ast.Name):
            out.add(node.func.id)
    return out


def _check_quality_staleness(ctx: FileContext):
    path = _norm(ctx.path)
    if not path.endswith(tuple(config.VL105_QUALITY_FILES)):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        called = _called_attrs(node)
        mutators = sorted(
            m for m in config.VL105_INDEX_MUTATORS if m in called
        )
        if not mutators or config.VL105_STALENESS_HOOK in called:
            continue
        ok, reason = ctx.func_allowed(node, "quality-staleness")
        yield Finding(
            "VL105", "quality-staleness", ctx.path, node.lineno,
            f"`{node.name}` calls {', '.join(mutators)} but never "
            f"calls {config.VL105_STALENESS_HOOK}() — the shadow "
            "recall estimators will score fresh ground truth against "
            "the pre-mutation serving snapshot (docs/QUALITY.md)",
            suppressed=ok, reason=reason,
        )


register(Rule(
    id="VL105", tag="quality-staleness",
    doc="index-mutating paths must call the quality staleness hook",
    check_file=_check_quality_staleness,
))
