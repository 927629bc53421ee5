"""Lock-discipline rules.

VL201 — `_guarded_by` enforcement. A class declares which lock guards
which attribute::

    class PSServer:
        _guarded_by = {
            "engines": "_lock",
            "applied": ("_lock", "_apply_lock"),
        }

Every mutation of ``self.<attr>`` (assignment, augmented assignment,
subscript store, del, or a mutator method call like ``.pop()``) must
then sit lexically inside ``with self.<lock>:`` for one of the declared
locks. ``__init__`` is exempt (construction happens-before
publication); a method whose *callers* all hold the lock declares
``# lint: holds[_lock]`` on its def line — a claim the runtime
lockcheck layer (VEARCH_LOCKCHECK=1) verifies instead of trusting.

VL202 — every ``threading.Thread(...)`` names itself and pins
``daemon=``. Anonymous threads make stack dumps and the lockcheck
acquisition graph unreadable, and an implicit non-daemon thread hangs
interpreter shutdown the first time its owner forgets to join it.

VL203 — ``time.time()`` is banned: monotonic clocks for anything
measured or compared (latency, deadlines, TTLs — NTP steps corrupt
wall-clock math), inline-justified `allow[wall-clock]` for genuinely
wall-anchored stamps (span epochs, persisted create times).
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _self_attr(node: ast.AST) -> str | None:
    """'attr' when node is `self.attr`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _mutation_root(target: ast.AST) -> str | None:
    """Attribute name mutated by an assignment target: `self.a`,
    `self.a[k]`, `self.a[k][j]` all root at 'a'."""
    cur = target
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    return _self_attr(cur)


def _guard_map(cls: ast.ClassDef) -> dict[str, tuple[str, ...]]:
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "_guarded_by"
                   for t in stmt.targets):
            continue
        if not isinstance(stmt.value, ast.Dict):
            return {}
        out: dict[str, tuple[str, ...]] = {}
        for k, v in zip(stmt.value.keys, stmt.value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                out[k.value] = (v.value,)
            elif isinstance(v, (ast.Tuple, ast.List)):
                locks = tuple(
                    e.value for e in v.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
                if locks:
                    out[k.value] = locks
        return out
    return {}


def _held_locks(ctx: FileContext, node: ast.AST) -> set[str]:
    """Lock attribute names lexically held at `node` via `with
    self.<name>:` ancestors (multiple with-items included)."""
    held: set[str] = set()
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                name = _self_attr(item.context_expr)
                if name:
                    held.add(name)
    return held


def _iter_mutations(func: ast.AST):
    """(node, attr, kind) for every self-attribute mutation in func."""
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for tt in targets:
                    attr = _mutation_root(tt)
                    if attr:
                        yield node, attr, "assignment"
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            attr = _mutation_root(node.target)
            if attr:
                yield node, attr, "assignment"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _mutation_root(t)
                if attr:
                    yield node, attr, "del"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in config.MUTATOR_METHODS:
            attr = _self_attr(node.func.value)
            if attr:
                yield node, attr, f".{node.func.attr}()"


def _check_guarded(ctx: FileContext):
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guards = _guard_map(cls)
        if not guards:
            continue
        for func in cls.body:
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if func.name == "__init__":
                continue
            fa, freason = ctx.func_allowed(func, "guarded")
            holds = ctx.func_holds(func)
            for node, attr, kind in _iter_mutations(func):
                locks = guards.get(attr)
                if locks is None:
                    continue
                inner = ctx.enclosing_function(node)
                if inner is not None and inner is not func and \
                        inner.name == "__init__":
                    continue
                held = _held_locks(ctx, node) | holds
                if inner is not None and inner is not func:
                    holds_inner = ctx.func_holds(inner)
                    held |= holds_inner
                if any(lk in held for lk in locks):
                    continue
                line = node.lineno
                ok, reason = ctx.allowed(line, "guarded")
                if not ok and fa:
                    ok, reason = True, freason
                want = " or ".join(f"self.{lk}" for lk in locks)
                yield Finding(
                    "VL201", "guarded", ctx.path, line,
                    f"{kind} to self.{attr} outside `with {want}` in "
                    f"{cls.name}.{func.name} (declared in _guarded_by)",
                    suppressed=ok, reason=reason,
                )


def _check_threads(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        is_thread = (
            (isinstance(func, ast.Attribute) and func.attr == "Thread"
             and isinstance(func.value, ast.Name)
             and func.value.id == "threading")
            or (isinstance(func, ast.Name) and func.id == "Thread")
        )
        if not is_thread:
            continue
        kw = {k.arg for k in node.keywords}
        missing = [k for k in ("daemon", "name") if k not in kw]
        if not missing:
            continue
        line = node.lineno
        ok, reason = ctx.allowed(line, "thread")
        yield Finding(
            "VL202", "thread", ctx.path, line,
            f"threading.Thread without {'/'.join(missing)}= — name "
            "every thread (stack dumps, lockcheck graphs) and pin "
            "daemonness explicitly",
            suppressed=ok, reason=reason,
        )


def _time_aliases(ctx: FileContext) -> tuple[set[str], set[str]]:
    """(module aliases of `time`, names bound to `time.time`)."""
    mods: set[str] = set()
    funcs: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name == "time":
                    funcs.add(a.asname or "time")
    return mods, funcs


def _check_wall_clock(ctx: FileContext):
    mods, funcs = _time_aliases(ctx)
    if not mods and not funcs:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        hit = (
            (isinstance(func, ast.Attribute) and func.attr == "time"
             and isinstance(func.value, ast.Name) and func.value.id in mods)
            or (isinstance(func, ast.Name) and func.id in funcs)
        )
        if not hit:
            continue
        line = node.lineno
        ok, reason = ctx.allowed(line, "wall-clock")
        yield Finding(
            "VL203", "wall-clock", ctx.path, line,
            "time.time() — use time.monotonic() for latency/deadline/"
            "TTL math; justify inline if a wall-anchored stamp is "
            "genuinely required",
            suppressed=ok, reason=reason,
        )


register(Rule(
    id="VL201", tag="guarded",
    doc="_guarded_by attributes mutate only under their declared lock",
    check_file=_check_guarded,
))

register(Rule(
    id="VL202", tag="thread",
    doc="threading.Thread requires explicit daemon= and name=",
    check_file=_check_threads,
))

register(Rule(
    id="VL203", tag="wall-clock",
    doc="time.time() banned; monotonic for measurements, justified "
        "pragma for wall stamps",
    check_file=_check_wall_clock,
))
