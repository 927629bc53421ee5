"""Whole-program call graph for the interprocedural lint rules.

Built once per lint run from the SAME parsed ``FileContext`` list the
lexical rules use (the package is parsed exactly once; see
``run_paths``). The graph gives the VL5xx family three things:

1. **Reachability** from the declared serving entry points
   (``config.INTERPROC_ENTRY_POINTS``) with the discovery chain kept,
   so a finding three helpers deep is reported with the full call path
   from the handler that makes it hot.
2. **Call resolution** with an explicit honesty ledger: every call
   site is classified ``resolved`` (precise target), ``fanout``
   (dynamic receiver, matched by method name across the project),
   ``external`` (known non-project module), or ``dynamic`` (we cannot
   say — the *unresolved bucket*). Rules treat the unresolved bucket
   conservatively instead of pretending it is empty.
3. **The static lock-order graph**: every ``with self._lock`` nesting,
   explicit ``.acquire()`` on a minted lock, and lock acquired
   *transitively* by a callee while another lock is held becomes a
   directed edge; cycles are deadlocks-in-waiting (VL503) and the
   edge set is the artifact the stress suite diffs runtime lockcheck
   edges against.

Resolution strategy (documented blind spots in STATIC_ANALYSIS.md):

- ``self.m()``       -> method lookup with a DFS MRO over parsed bases
- ``self.attr.m()``  -> type of ``attr`` inferred from
                        ``self.attr = Class(...)`` assignments or a
                        ``self.attr: dict[K, Class]`` annotation
                        (containers type as their VALUE class, so
                        ``self.nodes[pid].m()`` resolves too)
- ``mod.f()``        -> module alias / from-import tables per module
- ``var.m()``        -> flow-insensitive ``var = Class(...)`` typing,
                        plus return-annotation typing: ``var =
                        self._node(pid)`` types ``var`` when the
                        resolved callee is annotated ``-> Class``
- ``self.cb(...)``   -> constructor-injected callbacks: when every
                        observed binding site (``Class(..., cb=X)`` or
                        ``obj.cb = X``) passes a resolvable function,
                        lambda, or closure-returning call, the dynamic
                        ``self.cb(...)`` invocation resolves to those
                        targets (raft's ``apply_fn``/``observer``/
                        ``snapshot_fn`` pattern)
- anything else      -> name fan-out over every parsed class method of
                        that name, unless the name is in
                        ``config.FANOUT_STOPLIST`` (ubiquitous names
                        whose fan-out would connect everything), in
                        which case the call lands in the unresolved
                        bucket.

Nested ``def``s (closures handed to observers, hedges, executors) are
NOT scanned as part of their parent's body; instead a reachable parent
makes its nested defs reachable ("closure rule"), so the offending
frame in a report is the closure itself, where a pragma can sit.
"""

from __future__ import annotations

import ast
import builtins as _builtins
from dataclasses import dataclass, field

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext

__all__ = ["Analysis", "build", "analysis_for", "edge_covered"]

_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _module_name(path: str) -> str:
    parts = _norm(path)[:-3].split("/") if path.endswith(".py") \
        else _norm(path).split("/")
    if "vearch_tpu_torch" in parts:
        parts = parts[parts.index("vearch_tpu_torch"):]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


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


def _dotted_thru_subscript(node: ast.AST) -> str | None:
    """Dotted chain with subscripts elided: `self.nodes[pid].close`
    -> "self.nodes.close". Only returns a value when a subscript was
    actually present (plain chains take the exact `_dotted` path)."""
    parts: list[str] = []
    seen_sub = False
    cur = node
    while True:
        if isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            seen_sub = True
            cur = cur.value
        else:
            break
    if seen_sub and isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _expr_walk(node: ast.AST):
    """ast.walk that does not descend into nested function/class
    definitions (their bodies belong to other graph nodes)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, _FUNC + (ast.ClassDef,)):
                continue
            stack.append(child)


# -- graph node types ---------------------------------------------------------

@dataclass
class LockNode:
    """A statically-identified lock. `match` ties it to runtime
    lockcheck names: literal (exact make_lock string), prefix
    (f-string with a constant head), any (name passed as a parameter),
    none (a plain threading primitive lockcheck never sees)."""
    id: str
    match: str = "none"  # literal | prefix | any | none
    name: str = ""

    def matches(self, runtime_name: str) -> bool:
        if self.match == "literal":
            return runtime_name == self.name
        if self.match == "prefix":
            return runtime_name.startswith(self.name)
        return self.match == "any"


@dataclass
class CallRec:
    line: int
    dotted: str | None
    targets: tuple[str, ...]
    kind: str  # resolved | callback | fanout | external | dynamic
    # "callback": resolved through a binding pass (ctor-injected attr
    # or function-valued param). Lock-graph edges treat it as resolved
    # (the invocation frame is where ordering happens); reachability
    # SKIPS it — the binding call site already contributes a
    # context-correct deferred edge, and a global union here would
    # launder one entry's callbacks onto another entry's path.
    node: ast.Call = None


@dataclass
class FuncInfo:
    qual: str          # "module:Class.method" — globally unique
    module: str
    qualname: str      # "Class.method" / "func" / "outer.inner"
    name: str
    cls: str | None    # owning class key, if a method
    node: ast.AST
    ctx: FileContext
    nested: list[str] = field(default_factory=list)
    calls: list[CallRec] = field(default_factory=list)
    unresolved: list[tuple[str, int]] = field(default_factory=list)
    local_types: dict[str, set[str]] = field(default_factory=dict)
    # local name -> self attr it aliases (`obs = self.observer`)
    attr_aliases: dict[str, str] = field(default_factory=dict)
    # param name -> quals call sites pass for it (`resolve(.., fetch)`)
    param_callbacks: dict[str, set[str]] = field(default_factory=dict)
    # local name -> quals it holds (`fetch = self._make_fetch(...)`)
    local_callbacks: dict[str, set[str]] = field(default_factory=dict)
    lock_vars: dict[str, list[LockNode]] = field(default_factory=dict)
    direct_locks: set[str] = field(default_factory=set)  # LockNode ids


@dataclass
class ClassInfo:
    key: str           # "module:ClassName"
    module: str
    name: str
    node: ast.ClassDef
    bases: list[str] = field(default_factory=list)   # raw dotted names
    methods: dict[str, str] = field(default_factory=dict)  # name -> qual
    attr_types: dict[str, set[str]] = field(default_factory=dict)
    attr_locks: dict[str, LockNode] = field(default_factory=dict)
    cond_alias: dict[str, str] = field(default_factory=dict)
    minted: dict[str, LockNode] = field(default_factory=dict)
    # __init__ param name -> attr it is stored into (`self._observer =
    # observer`): lets constructor call sites bind callback targets
    param_attrs: dict[str, str] = field(default_factory=dict)
    # attr name -> quals every observed binding site passes for it
    callback_targets: dict[str, set[str]] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str
    ctx: FileContext
    funcs: dict[str, str] = field(default_factory=dict)    # name -> qual
    classes: dict[str, str] = field(default_factory=dict)  # name -> key
    mod_alias: dict[str, str] = field(default_factory=dict)
    from_bind: dict[str, tuple[str, str]] = field(default_factory=dict)
    # name -> ("module", dotted) | ("func", qual) | ("class", key)
    locks: dict[str, LockNode] = field(default_factory=dict)


class Analysis:
    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.method_index: dict[str, list[str]] = {}
        self.entries: list[tuple[str, str]] = []  # (qual, kind)
        # kind -> {qual: (parent_qual | None, call line in parent)}
        self.reach: dict[str, dict[str, tuple[str | None, int]]] = {}
        self.lock_nodes: dict[str, LockNode] = {}
        # (first_id, then_id) -> "path:line" of the inner acquisition
        self.lock_edges: dict[tuple[str, str], str] = {}
        self.lock_cycles: list[list[str]] = []
        # transitive acquire sets per function qual (LockNode ids)
        self.acq: dict[str, set[str]] = {}

    # -- queries -------------------------------------------------------------

    def reachable(self, kind: str) -> set[str]:
        return set(self.reach.get(kind, ()))

    def chain(self, qual: str, kind: str) -> list[str]:
        """Entry-to-qual call chain as recorded at first discovery."""
        parents = self.reach.get(kind, {})
        out, cur = [], qual
        while cur is not None and cur in parents and len(out) < 64:
            out.append(cur)
            cur = parents[cur][0]
        return list(reversed(out))

    def render_chain(self, qual: str, kind: str) -> str:
        names = [q.split(":", 1)[1] for q in self.chain(qual, kind)]
        return " -> ".join(names) if names else qual

    def lock_graph_artifact(self) -> dict:
        """Machine-readable lock graph (`lint --lock-graph`); the
        stress suite asserts runtime lockcheck edges are covered."""
        return {
            "nodes": [
                {"id": n.id, "match": n.match, "name": n.name}
                for n in sorted(self.lock_nodes.values(),
                                key=lambda n: n.id)
            ],
            "edges": [
                {"first": a, "then": b, "site": site}
                for (a, b), site in sorted(self.lock_edges.items())
            ],
            "cycles": self.lock_cycles,
        }

    def edge_covered(self, first_name: str, then_name: str) -> bool:
        for (a, b) in self.lock_edges:
            na, nb = self.lock_nodes[a], self.lock_nodes[b]
            if na.matches(first_name) and nb.matches(then_name):
                return True
        return False


def edge_covered(artifact: dict, first_name: str, then_name: str) -> bool:
    """Same coverage test against the serialized artifact."""
    nodes = {n["id"]: n for n in artifact["nodes"]}

    def _m(nid: str, runtime: str) -> bool:
        n = nodes[nid]
        if n["match"] == "literal":
            return runtime == n["name"]
        if n["match"] == "prefix":
            return runtime.startswith(n["name"])
        return n["match"] == "any"

    return any(_m(e["first"], first_name) and _m(e["then"], then_name)
               for e in artifact["edges"])


# -- builder ------------------------------------------------------------------

class _Builder:
    def __init__(self, contexts: list[FileContext]):
        self.a = Analysis()
        self.contexts = contexts

    # .. indexing ............................................................

    def build(self) -> Analysis:
        for ctx in self.contexts:
            self._index_module(ctx)
        for cls in self.a.classes.values():
            self._collect_attrs(cls)
        # local typing must precede the callback pass (binding sites
        # like `node.wal.observer = ...` need the receiver's type), and
        # both must precede the call-record walk so dynamic
        # `self.cb(...)` sites resolve against bound targets
        for fn in self.a.funcs.values():
            self._local_types(fn, self.a.modules[fn.module])
        # fixpoint: a callback forwarded through a call chain
        # (`resolve(fetch)` -> `_resolve_locked(fetch)` -> `_upload`)
        # binds one hop per pass
        for _ in range(4):
            before = self._binding_count()
            for fn in self.a.funcs.values():
                self._collect_callbacks(fn)
            if self._binding_count() == before:
                break
        for fn in self.a.funcs.values():
            self._scan_function(fn)
        self._find_entries()
        self._reachability()
        self._lock_graph()
        return self.a

    def _index_module(self, ctx: FileContext) -> None:
        mod = ModuleInfo(_module_name(ctx.path), ctx)
        # last parse wins on duplicate module names (fixture trees)
        self.a.modules[mod.name] = mod
        self._collect_imports(mod, ctx.tree)
        for stmt in ctx.tree.body:
            if isinstance(stmt, _FUNC):
                self._index_func(mod, stmt, prefix="", cls=None)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(mod, stmt)
            elif isinstance(stmt, ast.Assign):
                spec = self._make_lock_spec(stmt.value)
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and spec is not None:
                        node = self._lock_node(
                            f"{mod.name}:{t.id}", spec)
                        mod.locks[t.id] = node

    def _index_func(self, mod: ModuleInfo, node: ast.AST, prefix: str,
                    cls: str | None) -> FuncInfo:
        qualname = f"{prefix}{node.name}"
        qual = f"{mod.name}:{qualname}"
        fn = FuncInfo(qual, mod.name, qualname, node.name, cls, node,
                      mod.ctx)
        self.a.funcs[qual] = fn
        if not prefix:
            mod.funcs[node.name] = qual
        for child in ast.walk(node):
            if isinstance(child, _FUNC) and child is not node and \
                    self._direct_parent_func(mod.ctx, child) is node:
                sub = self._index_func(
                    mod, child, prefix=f"{qualname}.", cls=cls)
                fn.nested.append(sub.qual)
        return fn

    @staticmethod
    def _direct_parent_func(ctx: FileContext, node: ast.AST) -> ast.AST | None:
        cur = ctx.parents.get(node)
        while cur is not None and not isinstance(cur, _FUNC):
            if isinstance(cur, ast.ClassDef):
                return None
            cur = ctx.parents.get(cur)
        return cur

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        key = f"{mod.name}:{node.name}"
        ci = ClassInfo(key, mod.name, node.name, node)
        self.a.classes[key] = ci
        mod.classes[node.name] = key
        for b in node.bases:
            d = _dotted(b)
            if d:
                ci.bases.append(d)
        # leaf layers (the SDK client sits ABOVE the cluster, never
        # below the engine) are excluded from name fan-out, or their
        # same-named methods (search/upsert) would pull a client
        # round-trip onto the server's own serving path
        fanout_ok = not any(
            pkg in _norm(mod.ctx.path)
            for pkg in config.INTERPROC_FANOUT_EXCLUDE)
        for stmt in node.body:
            if isinstance(stmt, _FUNC):
                fn = self._index_func(
                    mod, stmt, prefix=f"{node.name}.", cls=key)
                ci.methods[stmt.name] = fn.qual
                if fanout_ok:
                    self.a.method_index.setdefault(
                        stmt.name, []).append(fn.qual)

    def _collect_imports(self, mod: ModuleInfo, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    top = al.name.split(".")[0]
                    mod.mod_alias[al.asname or top] = \
                        al.name if al.asname else top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = mod.name.split(".")
                    parts = parts[:len(parts) - node.level] if \
                        len(parts) >= node.level else []
                    base = ".".join(parts + ([node.module]
                                             if node.module else []))
                for al in node.names:
                    name = al.asname or al.name
                    mod.from_bind[name] = ("pending", f"{base}.{al.name}"
                                           if base else al.name)

    # .. lock + type extraction ..............................................

    def _lock_node(self, nid: str, spec: tuple[str, str]) -> LockNode:
        node = self.a.lock_nodes.get(nid)
        if node is None:
            node = LockNode(nid, spec[0], spec[1])
            self.a.lock_nodes[nid] = node
        elif node.match == "none" and spec[0] != "none":
            node.match, node.name = spec
        return node

    @staticmethod
    def _make_lock_spec(expr: ast.AST) -> tuple[str, str] | None:
        """("literal"|"prefix"|"any"|"none", name) when expr mints a
        lock-like object anywhere inside; None otherwise."""
        for node in _expr_walk(expr):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            last = d.split(".")[-1]
            if last == "make_lock":
                if not node.args:
                    return ("any", "")
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    return ("literal", arg.value)
                if isinstance(arg, ast.JoinedStr):
                    head = ""
                    for part in arg.values:
                        if isinstance(part, ast.Constant) and \
                                isinstance(part.value, str):
                            head += part.value
                        else:
                            break
                    return ("prefix", head) if head else ("any", "")
                return ("any", "")
            if last in ("Lock", "RLock", "Semaphore", "BoundedSemaphore") \
                    and d.split(".")[0] in ("threading", "_threading"):
                return ("none", "")
        return None

    def _collect_attrs(self, ci: ClassInfo) -> None:
        mod = self.a.modules[ci.module]
        init_params = self._init_params(ci)
        for stmt in ast.walk(ci.node):
            if isinstance(stmt, ast.Assign):
                # chained targets (`mb = self._mb = Cls(...)`) record
                # the attr type too
                for t in stmt.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        self._record_attr(ci, mod, t.attr, stmt.value)
                        if isinstance(stmt.value, ast.Name) and \
                                stmt.value.id in init_params:
                            ci.param_attrs[stmt.value.id] = t.attr
            elif isinstance(stmt, ast.AnnAssign):
                t = stmt.target
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    # `self.nodes: dict[int, RaftNode] = {}` — the
                    # annotation types the attr (containers type as
                    # their value class)
                    keys = self._annotation_keys(mod, stmt.annotation)
                    if keys:
                        ci.attr_types.setdefault(t.attr, set()) \
                            .update(keys)
                    if stmt.value is not None:
                        self._record_attr(ci, mod, t.attr, stmt.value)
            elif isinstance(stmt, ast.Call) and \
                    isinstance(stmt.func, ast.Attribute) and \
                    stmt.func.attr == "setdefault":
                base = stmt.func.value
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self" and len(stmt.args) == 2:
                    spec = self._make_lock_spec(stmt.args[1])
                    if spec is not None:
                        ci.attr_locks[base.attr] = self._lock_node(
                            f"{ci.name}.{base.attr}", spec)
        # methods that mint a lock (e.g. `_flush_lock(pid)` returning a
        # per-pid DebugLock): `with self._flush_lock(pid):` resolves
        # through them
        for mname, mqual in ci.methods.items():
            fnode = self.a.funcs[mqual].node
            spec = None
            for stmt in fnode.body:
                spec = spec or self._make_lock_spec(stmt)
            if spec is not None:
                # reuse the backing-attr node when the mint flows into
                # one (setdefault into self._flush_locks)
                backing = None
                for stmt in ast.walk(fnode):
                    if isinstance(stmt, ast.Call) and \
                            isinstance(stmt.func, ast.Attribute) and \
                            stmt.func.attr == "setdefault":
                        b = stmt.func.value
                        if isinstance(b, ast.Attribute) and \
                                isinstance(b.value, ast.Name) and \
                                b.value.id == "self":
                            backing = ci.attr_locks.get(b.attr)
                ci.minted[mname] = backing or self._lock_node(
                    f"{ci.name}.{mname}()", spec)

    def _record_attr(self, ci: ClassInfo, mod: ModuleInfo, attr: str,
                     value: ast.AST) -> None:
        spec = self._make_lock_spec(value)
        if spec is not None:
            ci.attr_locks[attr] = self._lock_node(
                f"{ci.name}.{attr}", spec)
            return
        if isinstance(value, ast.Call):
            d = _dotted(value.func) or ""
            if d.split(".")[-1] == "Condition":
                if value.args:
                    arg = value.args[0]
                    if isinstance(arg, ast.Attribute) and \
                            isinstance(arg.value, ast.Name) and \
                            arg.value.id == "self":
                        ci.cond_alias[attr] = arg.attr
                        return
                ci.attr_locks[attr] = self._lock_node(
                    f"{ci.name}.{attr}", ("none", ""))
                return
            keys = self._class_keys_of_call(mod, d)
            if keys:
                ci.attr_types.setdefault(attr, set()).update(keys)

    def _init_params(self, ci: ClassInfo) -> set[str]:
        qual = ci.methods.get("__init__")
        if qual is None:
            return set()
        args = self.a.funcs[qual].node.args
        names = [a.arg for a in args.posonlyargs + args.args +
                 args.kwonlyargs]
        return set(names[1:]) if names[:1] == ["self"] else set(names)

    def _annotation_keys(self, mod: ModuleInfo, ann: ast.AST) \
            -> set[str]:
        """Class keys a type annotation names. Containers (`dict[K, V]`,
        `list[T]`, `Optional[T]`) type as their LAST parameter — the
        element/value position — so subscripted reads type correctly."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return set()
        if isinstance(ann, (ast.Name, ast.Attribute)):
            return self._class_keys_of_call(mod, _dotted(ann) or "")
        if isinstance(ann, ast.Subscript):
            sl = ann.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            return self._annotation_keys(mod, elts[-1]) if elts else set()
        if isinstance(ann, ast.BinOp):  # PEP 604: `RaftNode | None`
            return self._annotation_keys(mod, ann.left) | \
                self._annotation_keys(mod, ann.right)
        return set()

    def _class_keys_of_call(self, mod: ModuleInfo, dotted: str) \
            -> set[str]:
        """Class keys a `Name(...)`/`mod.Name(...)` call constructs."""
        if not dotted:
            return set()
        parts = dotted.split(".")
        if len(parts) == 1:
            key = mod.classes.get(parts[0])
            if key:
                return {key}
            bind = self._resolve_from_bind(mod, parts[0])
            if bind and bind[0] == "class":
                return {bind[1]}
            return set()
        tmod = self._module_of_prefix(mod, parts[:-1])
        if tmod is not None:
            key = tmod.classes.get(parts[-1])
            if key:
                return {key}
        return set()

    def _resolve_from_bind(self, mod: ModuleInfo, name: str) \
            -> tuple[str, str] | None:
        """from-import binding -> ("module", dotted) | ("func", qual)
        | ("class", key) | ("external", dotted)."""
        bind = mod.from_bind.get(name)
        if bind is None:
            return None
        kind, target = bind
        if kind != "pending":
            return bind
        # sentinel first: re-export chasing below can revisit this
        # binding on an import cycle; the sentinel makes that a benign
        # "external" instead of infinite recursion
        mod.from_bind[name] = ("external", target)
        if target in self.a.modules:
            out = ("module", target)
        else:
            head, _, member = target.rpartition(".")
            src = self.a.modules.get(head)
            if src is not None and member in src.classes:
                out = ("class", src.classes[member])
            elif src is not None and member in src.funcs:
                out = ("func", src.funcs[member])
            elif src is not None and member in src.from_bind:
                # package __init__ re-export:
                # `from vearch_tpu_torch.tiering import HostRamSlabTier`
                # where tiering/__init__.py itself imports it
                out = self._resolve_from_bind(src, member) or \
                    ("external", target)
            else:
                out = ("external", target)
        mod.from_bind[name] = out
        return out

    def _module_of_prefix(self, mod: ModuleInfo, parts: list[str]) \
            -> ModuleInfo | None:
        """Module named by an attribute prefix like ["rpc"] or
        ["vearch_tpu_torch", "cluster", "rpc"]."""
        if not parts:
            return None
        head = parts[0]
        bind = self._resolve_from_bind(mod, head)
        if bind and bind[0] == "module":
            full = ".".join([bind[1]] + parts[1:])
        elif head in mod.mod_alias:
            full = ".".join([mod.mod_alias[head]] + parts[1:])
        else:
            full = ".".join(parts)
        return self.a.modules.get(full)

    def _method_lookup(self, key: str, name: str, seen=None) \
            -> str | None:
        seen = seen or set()
        if key in seen:
            return None
        seen.add(key)
        ci = self.a.classes.get(key)
        if ci is None:
            return None
        if name in ci.methods:
            return ci.methods[name]
        mod = self.a.modules[ci.module]
        for b in ci.bases:
            bkeys = self._class_keys_of_call(mod, b)
            for bk in bkeys:
                hit = self._method_lookup(bk, name, seen)
                if hit:
                    return hit
        return None

    def _lock_attr_lookup(self, key: str, attr: str, seen=None) \
            -> LockNode | None:
        seen = seen or set()
        if key in seen:
            return None
        seen.add(key)
        ci = self.a.classes.get(key)
        if ci is None:
            return None
        if attr in ci.cond_alias:
            return self._lock_attr_lookup(key, ci.cond_alias[attr])
        if attr in ci.attr_locks:
            return ci.attr_locks[attr]
        mod = self.a.modules[ci.module]
        for b in ci.bases:
            for bk in self._class_keys_of_call(mod, b):
                hit = self._lock_attr_lookup(bk, attr, seen)
                if hit:
                    return hit
        return None

    # .. per-function scan ...................................................

    def _scan_function(self, fn: FuncInfo) -> None:
        mod = self.a.modules[fn.module]
        walker = _FuncWalker(self, fn, mod)
        walker.run()

    def _local_types(self, fn: FuncInfo, mod: ModuleInfo) -> None:
        fargs = fn.node.args
        for a in fargs.posonlyargs + fargs.args + fargs.kwonlyargs:
            if a.annotation is not None:
                keys = self._annotation_keys(mod, a.annotation)
                if keys:
                    fn.local_types.setdefault(a.arg, set()).update(keys)
        for stmt in self._own_statements(fn.node):
            if not isinstance(stmt, ast.Assign):
                continue
            names = [t for t in stmt.targets if isinstance(t, ast.Name)]
            if not names:
                continue
            t = names[0]
            v = stmt.value
            spec = self._make_lock_spec(v)
            if spec is not None:
                for t in names:
                    fn.lock_vars.setdefault(t.id, []).append(
                        self._lock_node(f"{fn.qual}:{t.id}", spec))
                continue
            if isinstance(v, ast.Call):
                keys = self._class_keys_of_call(mod, _dotted(v.func) or "")
                if not keys and isinstance(v.func, ast.Attribute) and \
                        v.func.attr in ("get", "pop", "setdefault"):
                    # element access on a typed container:
                    # `node = self.raft_nodes.pop(pid, None)` types the
                    # local as the dict's value class
                    keys = self._expr_class_keys(fn, mod, v.func.value)
                if not keys:
                    # `node = self._node(pid)` with `_node -> RaftNode`:
                    # type the local from the callee's return annotation
                    targets, kind = self.resolve_call(fn, v)
                    if kind == "resolved":
                        for tq in targets:
                            tfn = self.a.funcs.get(tq)
                            ret = getattr(tfn.node, "returns", None) \
                                if tfn else None
                            if ret is not None:
                                keys |= self._annotation_keys(
                                    self.a.modules[tfn.module], ret)
                if keys:
                    for t in names:
                        fn.local_types.setdefault(t.id, set()) \
                            .update(keys)
            elif isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and v.value.id == "self" \
                    and fn.cls:
                ci = self.a.classes[fn.cls]
                keys = ci.attr_types.get(v.attr)
                for t in names:
                    fn.attr_aliases[t.id] = v.attr
                    if keys:
                        fn.local_types.setdefault(t.id, set()) \
                            .update(keys)

    def _own_statements(self, node: ast.AST):
        for child in _expr_walk(node):
            if isinstance(child, ast.stmt) and child is not node:
                yield child

    # .. constructor-injected callbacks ......................................

    def _collect_callbacks(self, fn: FuncInfo) -> None:
        """Bind function-valued values flowing into object attributes:
        `RaftNode(..., apply_fn=lambda op: self._apply(pid, op))` maps
        the ctor arg through ClassInfo.param_attrs, and
        `node.wal.observer = self._wal_observer(pid)` binds through the
        receiver's inferred type. The bound targets make later dynamic
        `self.apply_fn(...)` sites resolvable — at the INVOCATION
        frame, so lock ordering is recorded where the callback actually
        runs, not where it was bound."""
        mod = self.a.modules[fn.module]
        # locals holding callbacks first, so passing them as args below
        # (and in later fixpoint passes) binds through them
        for stmt in self._own_statements(fn.node):
            if not isinstance(stmt, ast.Assign):
                continue
            cbs = self._callback_targets(fn, stmt.value)
            if not cbs:
                continue
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    fn.local_callbacks.setdefault(
                        t.id, set()).update(cbs)
        for node in _expr_walk(fn.node):
            if isinstance(node, ast.Call):
                targets, kind = self.resolve_call(fn, node)
                if kind != "resolved":
                    continue
                for tq in targets:
                    tfn = self.a.funcs.get(tq)
                    if tfn is None:
                        continue
                    if tfn.name == "__init__" and tfn.cls is not None:
                        self._bind_ctor_args(
                            fn, self.a.classes[tfn.cls], tfn, node)
                    else:
                        self._bind_param_callbacks(fn, tfn, node)
            elif isinstance(node, ast.Assign):
                attrs = [t for t in node.targets
                         if isinstance(t, ast.Attribute)]
                if not attrs:
                    continue
                cbs = self._callback_targets(fn, node.value)
                if not cbs:
                    continue
                for t in attrs:
                    for key in self._expr_class_keys(fn, mod, t.value):
                        self.a.classes[key].callback_targets.setdefault(
                            t.attr, set()).update(cbs)

    def _bind_ctor_args(self, fn: FuncInfo, ci: ClassInfo,
                        init: FuncInfo, call: ast.Call) -> None:
        args = init.node.args
        params = [a.arg for a in args.posonlyargs + args.args][1:]
        pairs: list[tuple[str, ast.AST]] = []
        for i, arg in enumerate(call.args):
            if i < len(params):
                pairs.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                pairs.append((kw.arg, kw.value))
        for pname, value in pairs:
            attr = ci.param_attrs.get(pname)
            if attr is None:
                continue
            cbs = self._callback_targets(fn, value)
            if cbs:
                ci.callback_targets.setdefault(attr, set()).update(cbs)

    def _bind_param_callbacks(self, fn: FuncInfo, tfn: FuncInfo,
                              call: ast.Call) -> None:
        """Function-valued call arguments (`self.hbm.resolve(buckets,
        gens, self._fetch_slabs)`) bind to the callee's params so the
        callee's own `fetch(...)` invocation resolves — lock ordering
        lands at the invocation frame, under whatever the callee holds
        there."""
        args = tfn.node.args
        params = [a.arg for a in args.posonlyargs + args.args]
        if tfn.cls is not None and params[:1] == ["self"]:
            params = params[1:]
        named = set(params) | {a.arg for a in args.kwonlyargs}
        pairs: list[tuple[str, ast.AST]] = []
        for i, arg in enumerate(call.args):
            if i < len(params):
                pairs.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in named:
                pairs.append((kw.arg, kw.value))
        for pname, value in pairs:
            cbs = self._callback_targets(fn, value)
            if cbs:
                tfn.param_callbacks.setdefault(
                    pname, set()).update(cbs)

    def _binding_count(self) -> int:
        return sum(len(v) for ci in self.a.classes.values()
                   for v in ci.callback_targets.values()) + \
            sum(len(v) for fn in self.a.funcs.values()
                for v in fn.param_callbacks.values())

    def _callback_targets(self, fn: FuncInfo, expr: ast.AST) \
            -> set[str]:
        """Quals a function-valued expression will invoke: a lambda's
        resolvable body calls, a direct function/method reference, or a
        call to a factory that returns one of its own nested defs
        (`observer=self._raft_observer(pid)`)."""
        out: set[str] = set()
        mod = self.a.modules[fn.module]
        if isinstance(expr, ast.Lambda):
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    targets, kind = self.resolve_call(fn, sub)
                    if kind in ("resolved", "callback"):
                        out.update(targets)
        elif isinstance(expr, (ast.Name, ast.Attribute)):
            d = _dotted(expr)
            parts = d.split(".") if d else []
            if len(parts) == 2 and parts[0] == "self" and fn.cls:
                hit = self._method_lookup(fn.cls, parts[1])
                if hit:
                    out.add(hit)
            elif len(parts) == 1:
                if parts[0] in fn.local_callbacks:
                    out.update(fn.local_callbacks[parts[0]])
                else:
                    targets, kind = self._resolve_name_call(
                        fn, mod, parts[0])
                    if kind in ("resolved", "callback"):
                        out.update(targets)
        elif isinstance(expr, ast.Call):
            targets, kind = self.resolve_call(fn, expr)
            if kind == "resolved":
                for tq in targets:
                    tfn = self.a.funcs.get(tq)
                    if tfn is None:
                        continue
                    for stmt in self._own_statements(tfn.node):
                        if isinstance(stmt, ast.Return) and \
                                isinstance(stmt.value, ast.Name):
                            nq = f"{tfn.module}:{tfn.qualname}." \
                                 f"{stmt.value.id}"
                            if nq in tfn.nested:
                                out.add(nq)
        return out

    def _expr_class_keys(self, fn: FuncInfo, mod: ModuleInfo,
                         expr: ast.AST) -> set[str]:
        """Inferred class keys of a receiver expression: typed local,
        self attr, or an attribute chain over either (subscripts are
        transparent — containers type as their value class)."""
        if isinstance(expr, ast.Subscript):
            return self._expr_class_keys(fn, mod, expr.value)
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fn.cls:
                return {fn.cls}
            return set(fn.local_types.get(expr.id, ()))
        if isinstance(expr, ast.Attribute):
            out: set[str] = set()
            for base in self._expr_class_keys(fn, mod, expr.value):
                out |= self.a.classes[base].attr_types.get(
                    expr.attr, set())
            return out
        return set()

    def _callback_lookup(self, key: str, attr: str, seen=None) \
            -> set[str]:
        seen = seen or set()
        if key in seen:
            return set()
        seen.add(key)
        ci = self.a.classes.get(key)
        if ci is None:
            return set()
        if attr in ci.callback_targets:
            return ci.callback_targets[attr]
        mod = self.a.modules[ci.module]
        out: set[str] = set()
        for b in ci.bases:
            for bk in self._class_keys_of_call(mod, b):
                out |= self._callback_lookup(bk, attr, seen)
        return out

    # .. call resolution .....................................................

    def resolve_call(self, fn: FuncInfo, call: ast.Call) \
            -> tuple[tuple[str, ...], str]:
        """-> (target quals, kind)."""
        d = _dotted(call.func)
        mod = self.a.modules[fn.module]
        if d is None:
            # subscripted receivers (`self.nodes[pid].m()`) get one
            # shot at precise resolution through container value
            # types; anything short of "resolved" stays dynamic so
            # flattening never widens fan-out
            d = _dotted_thru_subscript(call.func)
            if d is not None:
                parts = d.split(".")
                targets, kind = (
                    self._resolve_name_call(fn, mod, parts[0])
                    if len(parts) == 1
                    else self._resolve_attr_call(fn, mod, parts))
                if kind == "resolved":
                    return targets, kind
            return (), "dynamic"
        parts = d.split(".")
        if len(parts) == 1:
            return self._resolve_name_call(fn, mod, parts[0])
        return self._resolve_attr_call(fn, mod, parts)

    def _resolve_name_call(self, fn: FuncInfo, mod: ModuleInfo,
                           name: str) -> tuple[tuple[str, ...], str]:
        # nested def in the same lexical function chain
        cur: FuncInfo | None = fn
        while cur is not None:
            child = f"{cur.module}:{cur.qualname}.{name}"
            if child in self.a.funcs:
                return (child,), "resolved"
            head, _, _ = cur.qualname.rpartition(".")
            cur = self.a.funcs.get(f"{cur.module}:{head}") if head else None
        pc = fn.param_callbacks.get(name) or \
            fn.local_callbacks.get(name)
        if pc:  # `fetch(...)` where every call site passed a known fn
            return tuple(sorted(pc)), "callback"
        alias = fn.attr_aliases.get(name)
        if alias and fn.cls:  # `obs = self.observer; obs(...)`
            hit = self._method_lookup(fn.cls, alias)
            if hit:
                return (hit,), "resolved"
            cb = self._callback_lookup(fn.cls, alias)
            if cb:
                return tuple(sorted(cb)), "callback"
        if name in mod.funcs:
            return (mod.funcs[name],), "resolved"
        if name in mod.classes:
            return self._ctor(mod.classes[name])
        bind = self._resolve_from_bind(mod, name)
        if bind:
            if bind[0] == "func":
                return (bind[1],), "resolved"
            if bind[0] == "class":
                return self._ctor(bind[1])
            return (), "external"
        if name in _PY_BUILTINS or hasattr(_builtins, name):
            return (), "external"
        return (), "dynamic"

    def _ctor(self, key: str) -> tuple[tuple[str, ...], str]:
        init = self._method_lookup(key, "__init__")
        return ((init,), "resolved") if init else ((), "resolved")

    def _resolve_attr_call(self, fn: FuncInfo, mod: ModuleInfo,
                           parts: list[str]) \
            -> tuple[tuple[str, ...], str]:
        method = parts[-1]
        base = parts[:-1]
        # self.m() / self.attr.m() / self.a.b.m() — attr chains walk
        # attr_types; bound callbacks resolve dynamic self.cb() sites
        if base[0] == "self" and fn.cls:
            if len(base) == 1:
                hit = self._method_lookup(fn.cls, method)
                if hit:
                    return (hit,), "resolved"
                cb = self._callback_lookup(fn.cls, method)
                if cb:
                    return tuple(sorted(cb)), "callback"
                return self._fanout(method)
            return self._chain_resolve(
                {fn.cls}, base[1:], method)
        # module-qualified: rpc.call(...), pkg.mod.f(...)
        tmod = self._module_of_prefix(mod, base)
        if tmod is not None:
            if method in tmod.funcs:
                return (tmod.funcs[method],), "resolved"
            if method in tmod.classes:
                return self._ctor(tmod.classes[method])
            return (), "external"
        head = base[0]
        bind = self._resolve_from_bind(mod, head)
        if head in mod.mod_alias or (bind and bind[0] in
                                     ("module", "external")):
            return (), "external"  # known external module
        if bind and bind[0] == "class" and len(base) == 1:
            hit = self._method_lookup(bind[1], method)
            if hit:
                return (hit,), "resolved"
        # typed local var (`node.m()`, `node.wal.m()`)
        types = set(fn.local_types.get(head, ()))
        if types:
            return self._chain_resolve(types, base[1:], method)
        return self._fanout(method)

    def _chain_resolve(self, keys: set[str], steps: list[str],
                       method: str) -> tuple[tuple[str, ...], str]:
        """Walk an attribute chain through attr_types, then look the
        method (or a bound callback) up on the final classes."""
        for step in steps:
            keys = {k2 for k in keys
                    for k2 in self.a.classes[k].attr_types.get(
                        step, ())}
        hits = {h for k in keys
                for h in [self._method_lookup(k, method)] if h}
        if hits:
            return tuple(sorted(hits)), "resolved"
        cb: set[str] = set()
        for k in keys:
            cb |= self._callback_lookup(k, method)
        if cb:
            return tuple(sorted(cb)), "callback"
        return self._fanout(method)

    def _fanout(self, method: str) -> tuple[tuple[str, ...], str]:
        if method in config.FANOUT_STOPLIST:
            return (), "dynamic"
        hits = self.a.method_index.get(method)
        if hits:
            return tuple(sorted(hits)), "fanout"
        return (), "dynamic"

    # .. lock expression resolution ..........................................

    def locks_of_expr(self, fn: FuncInfo, expr: ast.AST) \
            -> list[LockNode]:
        """LockNodes acquired by `with <expr>:` / `<expr>.acquire()`."""
        if isinstance(expr, ast.Subscript):
            return self.locks_of_expr(fn, expr.value)
        if isinstance(expr, ast.Name):
            if expr.id in fn.lock_vars:
                return list(fn.lock_vars[expr.id])
            mod = self.a.modules[fn.module]
            if expr.id in mod.locks:
                return [mod.locks[expr.id]]
            bind = self._resolve_from_bind(mod, expr.id)
            if bind and bind[0] == "external":
                head, _, member = bind[1].rpartition(".")
                src = self.a.modules.get(head)
                if src and member in src.locks:
                    return [src.locks[member]]
            return []
        if isinstance(expr, ast.Call):
            targets, kind = self.resolve_call(fn, expr)
            out = []
            for t in targets:
                tfn = self.a.funcs.get(t)
                if tfn is None or tfn.cls is None:
                    continue
                minted = self.a.classes[tfn.cls].minted.get(tfn.name)
                if minted:
                    out.append(minted)
            return out
        if isinstance(expr, ast.Attribute):
            d = _dotted(expr)
            if not d:
                return []
            parts = d.split(".")
            if parts[0] == "self" and fn.cls:
                if len(parts) == 2:
                    hit = self._lock_attr_lookup(fn.cls, parts[1])
                    if hit:
                        return [hit]
                    # unknown self attr in a with: plain lock
                    ci = self.a.classes[fn.cls]
                    return [self._lock_node(
                        f"{ci.name}.{parts[1]}", ("none", ""))]
                if len(parts) == 3:
                    ci = self.a.classes[fn.cls]
                    keys = ci.attr_types.get(parts[1], set())
                    out = []
                    for k in keys:
                        hit = self._lock_attr_lookup(k, parts[2])
                        if hit:
                            out.append(hit)
                    return out
            # lock attr on a typed local: lk.m is rare; skip
            types = fn.local_types.get(parts[0], set())
            out = []
            if len(parts) == 2:
                for k in types:
                    hit = self._lock_attr_lookup(k, parts[1])
                    if hit:
                        out.append(hit)
            return out
        return []

    # .. entries + reachability ..............................................

    def _find_entries(self) -> None:
        for suffix, qualname, kind in config.INTERPROC_ENTRY_POINTS:
            for fn in self.a.funcs.values():
                if fn.qualname == qualname and \
                        _norm(fn.ctx.path).endswith(suffix):
                    self.a.entries.append((fn.qual, kind))

    def _reachability(self) -> None:
        kinds = {k for _, k in self.a.entries}
        for kind in sorted(kinds):
            parents: dict[str, tuple[str | None, int]] = {}
            queue = [q for q, k in self.a.entries if k == kind]
            for q in queue:
                parents[q] = (None, 0)
            while queue:
                cur = queue.pop()
                fn = self.a.funcs[cur]
                succ: list[tuple[str, int]] = []
                for rec in fn.calls:
                    if rec.kind == "callback":
                        continue  # binding site already contributed
                    for t in rec.targets:
                        succ.append((t, rec.line))
                for n in fn.nested:  # closure rule
                    succ.append((n, self.a.funcs[n].node.lineno))
                for t, line in succ:
                    if t not in parents and t in self.a.funcs:
                        parents[t] = (cur, line)
                        queue.append(t)
            self.a.reach[kind] = parents

    # .. lock graph ..........................................................

    def _lock_graph(self) -> None:
        # transitive acquires: direct sets propagated caller <- callee
        # over precisely-resolved edges (fan-out edges would invent
        # orderings; documented blind spot)
        acq = {q: set(fn.direct_locks)
               for q, fn in self.a.funcs.items()}
        changed = True
        while changed:
            changed = False
            for q, fn in self.a.funcs.items():
                for rec in fn.calls:
                    if rec.kind not in ("resolved", "callback"):
                        continue
                    for t in rec.targets:
                        extra = acq.get(t, set()) - acq[q]
                        if extra:
                            acq[q] |= extra
                            changed = True
        self.a.acq = acq
        # expand held-across-call edges
        for q, fn in self.a.funcs.items():
            for held_ids, rec in getattr(fn, "_held_calls", ()):
                if rec.kind not in ("resolved", "callback"):
                    continue
                for t in rec.targets:
                    for m in acq.get(t, ()):
                        for h in held_ids:
                            if h != m:
                                self.a.lock_edges.setdefault(
                                    (h, m),
                                    f"{fn.ctx.path}:{rec.line}")
        self._cycles()

    def _cycles(self) -> None:
        graph: dict[str, set[str]] = {}
        for (a, b) in self.a.lock_edges:
            graph.setdefault(a, set()).add(b)
        # Tarjan SCC
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        onstack: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []

        def strongconnect(v: str) -> None:
            work = [(v, iter(sorted(graph.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack.add(w)
                        work.append((w, iter(sorted(graph.get(w, ())))))
                        advanced = True
                        break
                    if w in onstack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        for scc in sccs:
            if len(scc) > 1 or (len(scc) == 1 and
                                scc[0] in graph.get(scc[0], ())):
                self.a.lock_cycles.append(sorted(scc))


_PY_BUILTINS = {
    "len", "range", "print", "sorted", "enumerate", "zip", "min", "max",
    "sum", "abs", "isinstance", "getattr", "setattr", "hasattr", "repr",
    "str", "int", "float", "bool", "list", "dict", "set", "tuple",
    "frozenset", "bytes", "bytearray", "iter", "next", "type", "super",
    "id", "hash", "map", "filter", "any", "all", "round", "divmod",
    "vars", "format", "ord", "chr", "callable", "issubclass",
}


class _FuncWalker:
    """Statement-sequential walk of one function body: collects call
    records, unresolved names, direct lock acquisitions (with-blocks
    and explicit .acquire() on resolvable locks), and nesting edges."""

    def __init__(self, b: _Builder, fn: FuncInfo, mod: ModuleInfo):
        self.b = b
        self.fn = fn
        self.mod = mod
        self.held_calls: list[tuple[tuple[str, ...], CallRec]] = []

    def run(self) -> None:
        self._block(self.fn.node.body, self._initial_held())
        self.fn._held_calls = self.held_calls

    def _initial_held(self) -> tuple[str, ...]:
        held: list[str] = []
        if self.fn.cls:
            for name in self.fn.ctx.func_holds(self.fn.node):
                hit = self.b._lock_attr_lookup(self.fn.cls, name)
                if hit:
                    held.append(hit.id)
        return tuple(held)

    def _block(self, stmts, held: tuple[str, ...]) -> None:
        for stmt in stmts:
            held = self._stmt(stmt, held)

    def _stmt(self, stmt: ast.AST, held: tuple[str, ...]) \
            -> tuple[str, ...]:
        if isinstance(stmt, _FUNC + (ast.ClassDef,)):
            return held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                self._exprs(item.context_expr, inner)
                locks = self.b.locks_of_expr(self.fn, item.context_expr)
                for lk in locks:
                    self.fn.direct_locks.add(lk.id)
                    for h in inner:
                        if h != lk.id:
                            self.b.a.lock_edges.setdefault(
                                (h, lk.id),
                                f"{self.fn.ctx.path}:{stmt.lineno}")
                    inner = inner + (lk.id,)
            self._block(stmt.body, inner)
            return held
        sub_blocks = []
        exprs: list[ast.AST] = []
        if isinstance(stmt, (ast.If, ast.While)):
            exprs.append(stmt.test)
            sub_blocks = [stmt.body, stmt.orelse]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            exprs.append(stmt.iter)
            sub_blocks = [stmt.body, stmt.orelse]
        elif isinstance(stmt, ast.Try):
            sub_blocks = [stmt.body, stmt.orelse, stmt.finalbody] + \
                [h.body for h in stmt.handlers]
        if sub_blocks:
            for e in exprs:
                held = self._exprs(e, held)
            for blk in sub_blocks:
                self._block(blk, held)
            return held
        return self._exprs(stmt, held)

    def _exprs(self, node: ast.AST, held: tuple[str, ...]) \
            -> tuple[str, ...]:
        """Scan an expression/simple statement; explicit .acquire() on
        a resolvable lock extends `held` for the rest of the block
        (release tracking is deliberately ignored: over-approximation
        keeps the runtime-coverage direction safe)."""
        for call, in_lambda in self._calls_in(node):
            d = _dotted(call.func)
            if in_lambda:
                # a lambda body runs when the lambda is invoked, not
                # here: resolvable targets become deferred reachability
                # edges (no lock ordering, no held-across-call), while
                # unresolvable calls keep their primitive
                # classification for the blocking rules
                targets, kind = self.b.resolve_call(self.fn, call)
                if kind in ("resolved", "callback", "fanout"):
                    kind = "deferred"
                rec = CallRec(call.lineno, d, targets, kind, call)
                self.fn.calls.append(rec)
                if kind == "dynamic":
                    self.fn.unresolved.append(
                        (d or "<expr>", call.lineno))
                continue
            if d and d.endswith(".acquire"):
                locks = self.b.locks_of_expr(
                    self.fn, call.func.value)
                if locks:
                    for lk in locks:
                        self.fn.direct_locks.add(lk.id)
                        for h in held:
                            if h != lk.id:
                                self.b.a.lock_edges.setdefault(
                                    (h, lk.id),
                                    f"{self.fn.ctx.path}:{call.lineno}")
                        held = held + (lk.id,)
                    continue
            targets, kind = self.b.resolve_call(self.fn, call)
            rec = CallRec(call.lineno, d, targets, kind, call)
            self.fn.calls.append(rec)
            if kind == "dynamic":
                self.fn.unresolved.append((d or "<expr>", call.lineno))
            if held and kind in ("resolved", "callback"):
                self.held_calls.append((held, rec))
            # deferred-call rule: a project function passed BY VALUE
            # (executor.submit(self._call_partition, ...),
            # Thread(target=...), observer registration) will run
            # later — a reachability edge, but NOT a lock-ordering
            # edge (it executes on another thread/stack)
            for ref in self._func_refs(call):
                self.fn.calls.append(CallRec(
                    call.lineno, f"{_dotted(call.func)}->deferred",
                    (ref,), "deferred", call))
        return held

    def _func_refs(self, call: ast.Call) -> list[str]:
        refs: list[str] = []
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if not isinstance(arg, (ast.Name, ast.Attribute)):
                continue
            d = _dotted(arg)
            if not d:
                continue
            parts = d.split(".")
            if len(parts) == 2 and parts[0] == "self" and self.fn.cls:
                hit = self.b._method_lookup(self.fn.cls, parts[1])
                if hit:
                    refs.append(hit)
            elif len(parts) == 1:
                targets, kind = self.b._resolve_name_call(
                    self.fn, self.mod, parts[0])
                if kind == "resolved":
                    refs.extend(targets)
        return refs

    @staticmethod
    def _calls_in(node: ast.AST):
        out: list[tuple[ast.Call, bool]] = []

        def rec(n: ast.AST, in_lambda: bool) -> None:
            if isinstance(n, ast.Call):
                out.append((n, in_lambda))
            for child in ast.iter_child_nodes(n):
                if isinstance(child, _FUNC + (ast.ClassDef,)):
                    continue
                rec(child, in_lambda or isinstance(child, ast.Lambda))

        rec(node, isinstance(node, ast.Lambda))
        out.sort(key=lambda t: (t[0].lineno, t[0].col_offset))
        return out


# -- memoized entry point -----------------------------------------------------

_MEMO: dict[tuple[int, ...], Analysis] = {}
LAST: Analysis | None = None


def build(contexts: list[FileContext]) -> Analysis:
    return _Builder(list(contexts)).build()


def analysis_for(contexts: list[FileContext]) -> Analysis:
    """One shared Analysis per run_paths invocation: the four VL5xx
    rules (and the CLI artifact writers) key on the identity of the
    parsed-context list, so the package is analyzed once per run no
    matter how many rules consume it."""
    global LAST
    key = tuple(id(c) for c in contexts)
    hit = _MEMO.get(key)
    if hit is None:
        _MEMO.clear()  # one live entry: contexts die with the run
        hit = _MEMO[key] = build(contexts)
    LAST = hit
    return hit
