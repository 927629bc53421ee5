"""vearch-lint core: rule registry, file contexts, suppression.

The analyzer turns the project's prose invariants (ROADMAP, PERF.md,
OBSERVABILITY.md, review feedback) into machine-checked properties of
every future PR. It is deliberately dependency-free: stdlib `ast` over
the package tree, one process, no plugins.

Suppression model (both forms REQUIRE a reason — a bare waiver is
itself a finding):

- inline, for a single line::

      t = time.time()  # lint: allow[wall-clock] span epochs correlate with OTLP

  The pragma may also sit alone on the line directly above the
  flagged line. A pragma on a ``def`` line exempts the whole function
  for that rule (used for construction-time helpers).

- file-scoped, in the checked-in allowlist (one entry per line)::

      VL101 vearch_tpu_torch/parallel/sharded.py  device-parallel layer owns its dispatches

  Entries match by path suffix. Unused entries are reported as
  findings so the allowlist can only shrink or stay honest.

A function whose body runs entirely under a lock taken by every caller
declares it with ``# lint: holds[_lock]`` on its ``def`` line; the
static lock rule then treats the lock as held inside (the runtime
lockcheck layer verifies the claim when VEARCH_LOCKCHECK=1).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable

__all__ = [
    "Finding",
    "FileContext",
    "Rule",
    "Allowlist",
    "run_paths",
    "iter_py_files",
    "RULES",
    "register",
]

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\[([a-z0-9_-]+)\]\s*(.*)")
_HOLDS_RE = re.compile(r"#\s*lint:\s*holds\[([A-Za-z0-9_.,\s]+)\]")


@dataclass
class Finding:
    rule: str  # rule id, e.g. "VL203"
    tag: str  # pragma tag, e.g. "wall-clock"
    path: str  # path as given to the runner
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        sup = f"  [allowed: {self.reason}]" if self.suppressed else ""
        return f"{loc}: {self.rule}[{self.tag}] {self.message}{sup}"


@dataclass
class Rule:
    id: str
    tag: str
    doc: str
    # per-file rules get a FileContext; project rules get the list of
    # FileContexts (after every file parsed) for cross-file invariants
    check_file: Callable[["FileContext"], Iterable[Finding]] | None = None
    check_project: Callable[[list["FileContext"]], Iterable[Finding]] | None = None


RULES: list[Rule] = []


def register(rule: Rule) -> Rule:
    RULES.append(rule)
    return rule


class FileContext:
    """One parsed source file plus per-line pragma information."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> (tag, reason) inline allow pragmas
        self.allows: dict[int, tuple[str, str]] = {}
        # def-lines carrying a holds[] pragma: line -> set of lock names
        self.holds: dict[int, set[str]] = {}
        self.pragma_findings: list[Finding] = []
        for i, text in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(text)
            if m:
                tag, reason = m.group(1), m.group(2).strip()
                if not reason:
                    self.pragma_findings.append(Finding(
                        "VL000", "pragma", path, i,
                        f"allow[{tag}] pragma has no reason — every "
                        "waiver must say why",
                    ))
                self.allows[i] = (tag, reason)
            m = _HOLDS_RE.search(text)
            if m:
                names = {n.strip().lstrip("self.").strip()
                         for n in m.group(1).split(",")}
                self.holds[i] = {n for n in names if n}
        # parent links (ast doesn't keep them) for lexical-scope walks
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # -- pragma lookups ------------------------------------------------------

    def allowed(self, line: int, tag: str) -> tuple[bool, str]:
        """Inline suppression for (line, tag): same line, or a pragma
        alone on the line above."""
        hit = self.allows.get(line)
        if hit and hit[0] == tag:
            return True, hit[1]
        above = self.allows.get(line - 1)
        if above and above[0] == tag:
            text = self.lines[line - 2].strip() if line >= 2 else ""
            if text.startswith("#"):
                return True, above[1]
        return False, ""

    def func_allowed(self, func: ast.AST, tag: str) -> tuple[bool, str]:
        """allow[] pragma on the def line exempts the whole function."""
        line = getattr(func, "lineno", 0)
        hit = self.allows.get(line)
        if hit and hit[0] == tag:
            return True, hit[1]
        return False, ""

    def func_holds(self, func: ast.AST) -> set[str]:
        line = getattr(func, "lineno", 0)
        return self.holds.get(line, set())

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)


class Allowlist:
    """Checked-in, reason-carrying suppression file."""

    def __init__(self, path: str | None):
        self.path = path
        self.entries: list[tuple[str, str, str]] = []  # (rule, suffix, reason)
        self.used: set[int] = set()
        self.findings: list[Finding] = []
        if path and os.path.exists(path):
            for i, raw in enumerate(open(path), start=1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 2)
                if len(parts) < 3:
                    self.findings.append(Finding(
                        "VL000", "pragma", path, i,
                        "allowlist entry needs `RULE path reason`; a "
                        "reasonless waiver is not accepted",
                    ))
                    continue
                self.entries.append((parts[0], parts[1], parts[2]))

    def match(self, f: Finding) -> tuple[bool, str]:
        norm = f.path.replace(os.sep, "/")
        for i, (rule, suffix, reason) in enumerate(self.entries):
            if rule == f.rule and norm.endswith(suffix):
                self.used.add(i)
                return True, reason
        return False, ""

    def unused_findings(self) -> list[Finding]:
        out = []
        for i, (rule, suffix, reason) in enumerate(self.entries):
            if i not in self.used:
                out.append(Finding(
                    "VL000", "pragma", self.path or "<allowlist>", 0,
                    f"unused allowlist entry: {rule} {suffix} ({reason}) "
                    "— delete it",
                ))
        return out


def iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for fn in sorted(files):
                if fn.endswith(".py"):
                    yield os.path.join(root, fn)


def run_paths(
    paths: Iterable[str],
    allowlist: Allowlist | None = None,
    rules: Iterable[Rule] | None = None,
) -> list[Finding]:
    """Run every rule over every file; returns ALL findings, with
    suppressed ones marked (callers filter on `.suppressed`)."""
    # import for side effect: rule registration
    from vearch_tpu_torch.tools.lint import (  # noqa: F401
        rules_accounting, rules_buckets, rules_dispatch, rules_errors,
        rules_interproc, rules_locks, rules_obs, rules_quality,
    )

    active = list(rules) if rules is not None else list(RULES)
    contexts: list[FileContext] = []
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                ctx = FileContext(path, f.read())
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                "VL001", "parse", path, getattr(e, "lineno", 0) or 0,
                f"unparseable: {e}"))
            continue
        contexts.append(ctx)
        findings.extend(ctx.pragma_findings)
        for rule in active:
            if rule.check_file is not None:
                findings.extend(rule.check_file(ctx))
    for rule in active:
        if rule.check_project is not None:
            findings.extend(rule.check_project(contexts))
    if allowlist is not None:
        for f in findings:
            if f.suppressed:
                continue
            ok, reason = allowlist.match(f)
            if ok:
                f.suppressed, f.reason = True, reason
        findings.extend(allowlist.unused_findings())
    return findings
