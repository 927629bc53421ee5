"""Interprocedural serving-path rules (VL501–VL504).

All four share ONE whole-program analysis (`callgraph.analysis_for`)
built from the same parsed contexts the lexical rules already use, so
the package is parsed once and analyzed once per lint run.

VL501 — transitive dispatch. VL101 bans dispatch constructs outside
the device layers *lexically*; a pragma'd or allowlisted site can
still be laundered onto a serving path through helpers. VL501 re-runs
the check over every function *reachable from a serving entry point*
and reports the full call chain, so a waiver for "offline tooling"
stops holding the moment a handler can reach the site.

VL502 — transitive host-sync / blocking I/O on the search path. A
`time.sleep`, `open()`, socket call, unjustified `np.asarray`, or a
known mmap page-fault gather frame reachable from a search handler
stalls the request thread. Reported with the entry-to-frame chain;
the justification pragma must sit at the offending frame (tag
`serving-blocking`; the sync subset also honors the existing
`host-sync` pragmas so VL102's inventory carries over).

VL503 — static lock-order graph. Every `with <lock>` nesting,
explicit `.acquire()` on a minted lock, and lock taken transitively
by a callee while another is held is a directed edge; a cycle is a
deadlock the runtime lockcheck would only catch if the schedule got
unlucky. The edge set is exported (`lint --lock-graph`) and the
stress suite asserts runtime lockcheck edges ⊆ this graph.

VL504 — deadline propagation. Every `rpc.call` boundary reachable
from a search handler must thread the request deadline: a `timeout=`
derived from the armed RequestContext, or a literal body dict
carrying `deadline_ms` for the callee to arm its own context. A
dropped deadline is an unkillable downstream call — the 499 kill
machinery cannot reach work the caller never bounded.

The port's copy of vearch_tpu/tools/lint/rules_interproc.py: VL501 and
VL502's sync subset read PyTorch's constructs through rules_dispatch's
`is_dispatch` and `torch_sync_hit`.
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import callgraph, config
from vearch_tpu_torch.tools.lint.rules_dispatch import (
    is_dispatch, torch_sync_hit,
)
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _allowed_at(ctx: FileContext, fn, line: int, tags: tuple[str, ...]) \
        -> tuple[bool, str]:
    for tag in tags:
        ok, reason = ctx.allowed(line, tag)
        if ok:
            return ok, reason
        ok, reason = ctx.func_allowed(fn.node, tag)
        if ok:
            return ok, reason
    return False, ""


# -- VL501 --------------------------------------------------------------------

def _check_transitive_dispatch(contexts: list[FileContext]):
    a = callgraph.analysis_for(contexts)
    reach: dict[str, str] = {}
    for kind in ("search", "write"):
        for q in a.reachable(kind):
            reach.setdefault(q, kind)
    for qual, kind in sorted(reach.items()):
        fn = a.funcs[qual]
        path = _norm(fn.ctx.path)
        if any(pkg in path for pkg in config.DISPATCH_PACKAGES):
            continue
        hits: list[tuple[int, str]] = []
        for rec in fn.calls:
            if is_dispatch(rec.dotted or ""):
                hits.append((rec.line, rec.dotted))
        for dec in getattr(fn.node, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            dname = _dotted(target)
            if dname and is_dispatch(dname):
                hits.append((dec.lineno, dname))
        for line, name in hits:
            ok, reason = _allowed_at(
                fn.ctx, fn, line, ("transitive-dispatch",))
            yield Finding(
                "VL501", "transitive-dispatch", fn.ctx.path, line,
                f"`{name}` dispatches outside the device layers on a "
                f"{kind} serving path: "
                f"{a.render_chain(qual, kind)} — the perf model "
                "cannot see programs born here",
                suppressed=ok, reason=reason,
            )


# -- VL502 --------------------------------------------------------------------

_SYNC_TAGS = ("serving-blocking", "host-sync")
_IO_TAGS = ("serving-blocking",)


def _sync_hit(rec) -> str | None:
    node = rec.node
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in config.HOST_SYNC_METHODS and not node.args:
        return f".{attr}()"
    if attr in config.HOST_SYNC_CALLS:
        base = _dotted(node.func.value)
        if base in ("np", "numpy", "_np", "jax", "jnp"):
            return f"{base}.{attr}(...)"
    return torch_sync_hit(node)


def _io_hit(rec, fn, analysis) -> str | None:
    d = rec.dotted or ""
    parts = d.split(".")
    if rec.kind in ("external", "dynamic"):
        if len(parts) == 1 and parts[0] in config.VL502_BLOCKING_BARE:
            return f"{d}(...)"
        if len(parts) >= 2:
            mod = analysis.modules[fn.module]
            base = ".".join(parts[:-1])
            real = mod.mod_alias.get(parts[0])
            if real is not None:
                base = ".".join([real] + parts[1:-1])
            funcs = config.VL502_BLOCKING_MODULES.get(base)
            if funcs is not None and (not funcs or parts[-1] in funcs):
                return f"{base}.{parts[-1]}(...)"
            if funcs is None and base in config.VL502_BLOCKING_MODULES \
                    and config.VL502_BLOCKING_MODULES[base] is None:
                return f"{base}.{parts[-1]}(...)"
    if rec.kind == "dynamic" and len(parts) >= 2 and \
            parts[-1] in config.VL502_BLOCKING_METHODS:
        return f".{parts[-1]}(...) on an untyped handle"
    return None


def _check_transitive_blocking(contexts: list[FileContext]):
    a = callgraph.analysis_for(contexts)
    for qual in sorted(a.reachable("search")):
        fn = a.funcs[qual]
        path = _norm(fn.ctx.path)
        sync_exempt = any(pkg in path
                          for pkg in config.VL502_SYNC_EXEMPT_PACKAGES)
        chain = a.render_chain(qual, "search")
        for rec in fn.calls:
            hit, tags = None, _IO_TAGS
            if not sync_exempt:
                hit = _sync_hit(rec)
                if hit:
                    tags = _SYNC_TAGS
            if hit is None:
                hit = _io_hit(rec, fn, a)
            if hit is None:
                continue
            ok, reason = _allowed_at(fn.ctx, fn, rec.line, tags)
            yield Finding(
                "VL502", "serving-blocking", fn.ctx.path, rec.line,
                f"`{hit}` blocks the request thread on a search "
                f"serving path: {chain} — justify at this frame or "
                "hoist off the request thread",
                suppressed=ok, reason=reason,
            )
        # known mmap page-fault gather frames (subscript gathers the
        # resolver cannot see as calls)
        for suffix, qn in config.VL502_PAGEFAULT_FUNCS:
            if path.endswith(suffix) and fn.qualname == qn:
                ok, reason = _allowed_at(
                    fn.ctx, fn, fn.node.lineno, _IO_TAGS)
                yield Finding(
                    "VL502", "serving-blocking", fn.ctx.path,
                    fn.node.lineno,
                    f"mmap page-fault gather frame `{qn}` on a search "
                    f"serving path: {chain} — justify the fault cost "
                    "at this frame (readahead/cache mitigation) or "
                    "hoist",
                    suppressed=ok, reason=reason,
                )


# -- VL503 --------------------------------------------------------------------

def _check_lock_cycles(contexts: list[FileContext]):
    a = callgraph.analysis_for(contexts)
    for cycle in a.lock_cycles:
        members = set(cycle)
        site_path, site_line = "<lock-graph>", 0
        for (x, y), site in sorted(a.lock_edges.items()):
            if x in members and y in members:
                site_path, _, line = site.rpartition(":")
                site_line = int(line)
                break
        yield Finding(
            "VL503", "lock-order", site_path, site_line,
            "static lock-order cycle: " + " -> ".join(
                cycle + [cycle[0]]) + " — a schedule interleaving "
            "these acquisitions deadlocks; break the cycle or impose "
            "a total order",
        )


# -- VL504 --------------------------------------------------------------------

def _is_boundary(rec) -> bool:
    if any(t.endswith(s) for t in rec.targets
           for s in config.VL504_BOUNDARY_SUFFIXES):
        return True
    d = rec.dotted or ""
    return any(d == b or d.endswith("." + b)
               for b in config.VL504_BOUNDARY_DOTTED)


def _threads_deadline(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg in config.VL504_DEADLINE_KWARGS:
            return True
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Dict):
            for k in arg.keys:
                if isinstance(k, ast.Constant) and \
                        k.value == config.VL504_BODY_DEADLINE_KEY:
                    return True
    return False


def _check_deadline_propagation(contexts: list[FileContext]):
    a = callgraph.analysis_for(contexts)
    for qual in sorted(a.reachable("search")):
        fn = a.funcs[qual]
        chain = a.render_chain(qual, "search")
        for rec in fn.calls:
            if not _is_boundary(rec) or rec.node is None:
                continue
            if _threads_deadline(rec.node):
                continue
            ok, reason = _allowed_at(
                fn.ctx, fn, rec.line, ("deadline",))
            yield Finding(
                "VL504", "deadline", fn.ctx.path, rec.line,
                f"RPC boundary `{rec.dotted}` on a search serving "
                f"path drops the request deadline: {chain} — pass "
                "timeout= from the armed RequestContext or carry "
                "deadline_ms in the body, or the 499 kill machinery "
                "cannot bound this call",
                suppressed=ok, reason=reason,
            )


register(Rule(
    id="VL501", tag="transitive-dispatch",
    doc="no dispatch constructs reachable from serving entry points "
        "outside the device layers (interprocedural VL101)",
    check_project=_check_transitive_dispatch,
))

register(Rule(
    id="VL502", tag="serving-blocking",
    doc="no unjustified host-sync/blocking-I/O reachable from search "
        "handlers; reported with the full call chain",
    check_project=_check_transitive_blocking,
))

register(Rule(
    id="VL503", tag="lock-order",
    doc="static with-lock acquisition graph must be cycle-free "
        "(artifact: lint --lock-graph)",
    check_project=_check_lock_cycles,
))

register(Rule(
    id="VL504", tag="deadline",
    doc="serving-path RPC boundaries must thread the request "
        "deadline (timeout= or body deadline_ms)",
    check_project=_check_deadline_propagation,
))
