"""Error-handling rules.

VL301 — no bare ``except:`` anywhere. It catches KeyboardInterrupt and
SystemExit, turning an operator's Ctrl-C into silent state corruption.

VL302 — in the replication-critical modules (raft, WAL), a broad
handler (``except Exception``/``BaseException``) must do at least one
of: re-raise, log, or count through ``internal_error()`` /
``.inc(...)``. A silently-swallowed exception in an apply or commit
path is a replica that diverged without a trace — the failure the
whole observability stack exists to surface.
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _check_bare_except(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            line = node.lineno
            ok, reason = ctx.allowed(line, "bare-except")
            yield Finding(
                "VL301", "bare-except", ctx.path, line,
                "bare `except:` catches KeyboardInterrupt/SystemExit — "
                "name the exceptions you mean to handle",
                suppressed=ok, reason=reason,
            )


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [getattr(e, "attr", getattr(e, "id", "")) for e in t.elts]
    else:
        names = [getattr(t, "attr", getattr(t, "id", ""))]
    return any(n in ("Exception", "BaseException") for n in names)


def _handles_visibly(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Attribute):
                name = node.func.attr
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            if name in config.LOG_CALL_NAMES or \
                    name in config.ERROR_COUNT_CALLS:
                return True
    return False


def _check_swallow(ctx: FileContext):
    path = ctx.path.replace("\\", "/")
    if not any(path.endswith(m) for m in config.CRITICAL_ERROR_MODULES):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node) or _handles_visibly(node):
            continue
        line = node.lineno
        ok, reason = ctx.allowed(line, "swallow")
        yield Finding(
            "VL302", "swallow", ctx.path, line,
            "broad except swallows the exception silently in a "
            "replication-critical module — re-raise, log, or count it "
            "via internal_error(site)",
            suppressed=ok, reason=reason,
        )


register(Rule(
    id="VL301", tag="bare-except",
    doc="no bare except: anywhere in the package",
    check_file=_check_bare_except,
))

register(Rule(
    id="VL302", tag="swallow",
    doc="raft/WAL broad excepts must raise, log, or count",
    check_file=_check_swallow,
))
