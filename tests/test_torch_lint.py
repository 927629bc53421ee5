"""vearch-lint for vearch_tpu_torch (vearch_tpu_torch/tools/lint/) held
against the reference's (vearch_tpu/tools/lint/) on the CPU.

- Copies: every file of the port's lint package is the reference's with
  `vearch_tpu` rewritten to `vearch_tpu_torch`, plus the edits
  STATED_EDITS names: PyTorch's constructs in config.py,
  rules_dispatch.py and rules_interproc.py, and docstrings.
- Parity: each rule case of tests/test_lint.py is one snippet, linted by
  both packages under their own package path (`vearch_tpu/...` for the
  reference, `vearch_tpu_torch/...` for the port, the snippet's imports
  rewritten the same way). Both give the same findings (rule, tag,
  line, suppressed, message after the same rewrite), the unsuppressed
  rules the case expects, and equal lock-order artifacts (what
  `--lock-graph` prints). The call-graph cases compare reachability,
  call kinds and lock-edge coverage the same way.
- PyTorch's constructs, the stated departures: `.cpu()`, any
  `.synchronize()`, `.tolist()` / `.numpy()` of a visible tensor, and
  `register_op`, `CudaLibrary`, `torch.compile`, `torch.jit.script`,
  `torch.cuda.CUDAGraph`, `cpp_extension.load` outside the device
  layers fire in the port's linter and not in the reference's; `.item()`
  and `np.asarray(t)` fire in both; a numpy array's `.tolist()` (the
  router's merge), `HostExtension`, `re.compile` and `json.load` stay
  silent in both. A line marked `# both: RULES` must give those findings
  in both linters, one marked `# port: RULES` in the port's only.
- The gate: `python -m vearch_tpu_torch.tools.lint vearch_tpu_torch/`
  exits 0 with every finding waived with a reason; the CLI's
  `--list-rules`, `--json`, `--lock-graph` and `--changed-only`; one
  parse per file and a whole-package run under 30 s.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from vearch_tpu.tools.lint import callgraph as ref_callgraph
from vearch_tpu.tools.lint import core as ref_core
from vearch_tpu_torch.tools.lint import callgraph as pt_callgraph
from vearch_tpu_torch.tools.lint import config as pt_config
from vearch_tpu_torch.tools.lint import core as pt_core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vearch_tpu_torch")
LINT = "vearch_tpu_torch.tools.lint"


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


def _to_port(text: str) -> str:
    return re.sub(r"\bvearch_tpu\b", "vearch_tpu_torch", text)


def _to_ref(text: str) -> str:
    return text.replace("vearch_tpu_torch", "vearch_tpu")


def _replace(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


# -- copies -----------------------------------------------------------------------

LINT_FILES = sorted(os.listdir(os.path.join(REPO, "vearch_tpu", "tools",
                                            "lint")))
LINT_FILES = [f for f in LINT_FILES if f.endswith((".py", ".txt"))]

TORCH_HELPERS = '''def is_dispatch(name: str) -> bool:
    """Whether a call's or decorator's dotted name creates a device
    program: the reference's constructs and the port's by last name,
    the port's generic-named ones by dotted suffix."""
    last = name.split(".")[-1]
    if last in config.DISPATCH_CONSTRUCTS or \\
            last in config.TORCH_DISPATCH_NAMES:
        return True
    return any(name == d or name.endswith("." + d)
               for d in config.TORCH_DISPATCH_DOTTED)


def _visibly_tensor(expr: ast.AST) -> bool:
    """Whether an expression is seen to be a tensor: walking down its
    attribute, subscript and method-call chain reaches a `torch.` call
    or a tensor-only method (`.cpu()`, `.cuda()`, `.detach()`)."""
    cur = expr
    while True:
        if isinstance(cur, ast.Call):
            name = _dotted(cur.func)
            if name and name.split(".")[0] == "torch":
                return True
            if not isinstance(cur.func, ast.Attribute):
                return False
            if cur.func.attr in config.TORCH_TENSOR_METHODS:
                return True
            cur = cur.func.value
        elif isinstance(cur, (ast.Attribute, ast.Subscript)):
            cur = cur.value
        else:
            return False


def torch_sync_hit(call: ast.Call) -> str | None:
    """A PyTorch host sync at this call, beyond the reference's
    `.item()` / `np.asarray` hits; None for anything else."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in config.TORCH_SYNC_METHODS and not call.args:
        return f".{attr}()"
    if attr in config.TORCH_SYNC_ANY_ARGS:
        name = _dotted(call.func)
        return f"{name}(...)" if name else f".{attr}(...)"
    if attr in config.TORCH_MATERIALIZE_METHODS and not call.args \\
            and _visibly_tensor(call.func.value):
        return f".{attr}() of a tensor"
    return None


'''

# (old, new) in the reference's file after the rewrite
STATED_EDITS = {
    "config.py": [
        ('''scanned file path, so the linter works from any working directory.
"""''', '''scanned file path, so the linter works from any working directory.

The port's copy of vearch_tpu/tools/lint/config.py: the path tables are
re-rooted at vearch_tpu_torch/, and VL101/VL501 and VL102/VL502 also
read PyTorch's constructs (TORCH_DISPATCH_*, TORCH_SYNC_*).
"""'''),
        ('''    "jit", "pmap", "pallas_call", "shard_map", "xla_computation",
}
''', '''    "jit", "pmap", "pallas_call", "shard_map", "xla_computation",
}

# The port's device programs: the perf model's program registry
# (ops/perf_model.register_op), a CUDA library build (ops/_cuda_build
# .CudaLibrary), and PyTorch's compiled or captured programs. Matched by
# last name...
TORCH_DISPATCH_NAMES = {"register_op", "CudaLibrary", "CUDAGraph",
                        "load_inline"}
# ...and, where the last name alone is generic (`re.compile`,
# `json.load`), as a dotted suffix of the call's name. HostExtension
# builds host C++ (native/) and is not a dispatch.
TORCH_DISPATCH_DOTTED = ("torch.compile", "jit.script", "jit.trace",
                         "cuda.graph", "cpp_extension.load")
'''),
        ('''HOST_SYNC_CALLS = {"device_get", "asarray", "array"}
''', '''HOST_SYNC_CALLS = {"device_get", "asarray", "array"}

# PyTorch's host syncs besides `.item()` and np.asarray/np.array: a
# device-to-host copy (`.cpu()`), any `.synchronize()` (torch.cuda's,
# an event's, a stream's), and a materialisation (`.tolist()`,
# `.numpy()`) whose receiver is visibly a tensor: a chain that reaches
# a `torch.` call or one of TORCH_TENSOR_METHODS. A numpy array's
# `.tolist()` is host work and does not count.
TORCH_SYNC_METHODS = {"cpu"}
TORCH_SYNC_ANY_ARGS = {"synchronize"}
TORCH_MATERIALIZE_METHODS = {"tolist", "numpy"}
TORCH_TENSOR_METHODS = {"cpu", "cuda", "detach"}
'''),
    ],
    "rules_dispatch.py": [
        ('''materialisation) carry an inline `allow[host-sync]` reason.
"""''', '''materialisation) carry an inline `allow[host-sync]` reason.

The port's copy of vearch_tpu/tools/lint/rules_dispatch.py. Both rules
also read PyTorch's constructs (tools/lint/config.py): `register_op`,
`CudaLibrary`, `torch.compile`, `torch.jit.script` / `trace`,
`torch.cuda.CUDAGraph` / `graph` and `cpp_extension.load` /
`load_inline` create programs (`is_dispatch`); `.cpu()`, any
`.synchronize()`, and `.tolist()` / `.numpy()` on a visible tensor are
host syncs (`torch_sync_hit`).
"""'''),
        ("def _check_dispatch(ctx: FileContext):",
         TORCH_HELPERS + "def _check_dispatch(ctx: FileContext):"),
        ('''                if dname and dname.split(".")[-1] in \\
                        config.DISPATCH_CONSTRUCTS:
''', '''                if dname and is_dispatch(dname):
'''),
        ('''        last = name.split(".")[-1]
        if last not in config.DISPATCH_CONSTRUCTS:
''', '''        if not is_dispatch(name):
'''),
        ('''                        hit = f"{base}.{attr}(...)"
            if hit is None:
                continue''', '''                        hit = f"{base}.{attr}(...)"
            if hit is None:
                hit = torch_sync_hit(node)
            if hit is None:
                continue'''),
    ],
    "rules_interproc.py": [
        ('''machinery cannot reach work the caller never bounded.
"""''', '''machinery cannot reach work the caller never bounded.

The port's copy of vearch_tpu/tools/lint/rules_interproc.py: VL501 and
VL502's sync subset read PyTorch's constructs through rules_dispatch's
`is_dispatch` and `torch_sync_hit`.
"""'''),
        ('''from vearch_tpu_torch.tools.lint import callgraph, config
''', '''from vearch_tpu_torch.tools.lint import callgraph, config
from vearch_tpu_torch.tools.lint.rules_dispatch import (
    is_dispatch, torch_sync_hit,
)
'''),
        ('''            last = (rec.dotted or "").split(".")[-1]
            if last in config.DISPATCH_CONSTRUCTS:
''', '''            if is_dispatch(rec.dotted or ""):
'''),
        ('''            if dname and dname.split(".")[-1] in \\
                    config.DISPATCH_CONSTRUCTS:
''', '''            if dname and is_dispatch(dname):
'''),
        ('''            return f"{base}.{attr}(...)"
    return None
''', '''            return f"{base}.{attr}(...)"
    return torch_sync_hit(node)
'''),
    ],
    "rules_obs.py": [
        ('''This is the old ``scripts/check_obs_docs.py`` folded into the lint
framework — the script remains as a thin CLI delegating here, and
``tests/test_obs_docs.py`` keeps gating tier-1 through it.
''', '''The port's copy of vearch_tpu/tools/lint/rules_obs.py, and the one home
of the port's drift helpers: the doctor's ``obs_docs`` check
(obs/doctor.py) reads them. The port's check reads docs/OBSERVABILITY.md
and the port's own docs/OBSERVABILITY_TORCH.md as one (``doc_paths``,
``drift_failures_over``).
'''),
        # the port's names that the reference does not emit are
        # documented in docs/OBSERVABILITY_TORCH.md, read with the shared
        # doc as one
        ('''import os
''', '''import fnmatch
import os
'''),
        ('''    return os.path.join(repo_root(), "docs", "OBSERVABILITY.md")
''', '''    return os.path.join(repo_root(), "docs", "OBSERVABILITY.md")


def doc_paths() -> list[str]:
    """The docs the port's drift check reads as one: the shared
    docs/OBSERVABILITY.md and the port's own docs/OBSERVABILITY_TORCH.md,
    which lists what only the port emits."""
    return [default_doc_path(),
            os.path.join(repo_root(), "docs", "OBSERVABILITY_TORCH.md")]
'''),
        ('''def check_package(''', '''def drift_failures_over(
    src_metrics: set[str], src_spans: set[str], src_tags: set[str],
    doc_paths: list[str],
) -> list[str]:
    """`drift_failures` with the docs read as one: a name is undocumented
    when no doc names it, and documented in vain when a doc names it and
    nothing emits it. A documented family (`stage.{phase}`) is emitted
    when a name of that family is (`stage.flush`)."""
    per_doc = [drift_failures(src_metrics, src_spans, src_tags, p)
               for p in doc_paths]
    out: list[str] = []
    for failures in per_doc:
        for failure in failures:
            kind, _, name = failure.partition(": ")
            if kind.endswith("undocumented"):
                keep = all(failure in other for other in per_doc)
            else:
                keep = not (kind == "span documented but never emitted"
                            and any(fnmatch.fnmatchcase(s, name)
                                    for s in src_spans))
            if keep and failure not in out:
                out.append(failure)
    return out


def check_package('''),
        ('''    doc = doc_path or default_doc_path()
    metrics, spans, tags = source_names(src)
    return drift_failures(metrics, spans, tags, doc)
''', '''    docs = [doc_path] if doc_path else doc_paths()
    metrics, spans, tags = source_names(src)
    return drift_failures_over(metrics, spans, tags, docs)
'''),
        ('''    for failure in drift_failures(metrics, spans, tags, doc):
''', '''    for failure in drift_failures_over(metrics, spans, tags, doc_paths()):
'''),
    ],
}


@pytest.mark.parametrize("name", LINT_FILES)
def test_lint_file_is_the_reference_copy_with_its_stated_edits(name):
    ref = _to_port(_read("vearch_tpu", "tools", "lint", name))
    for old, new in STATED_EDITS.get(name, []):
        ref = _replace(ref, old, new)
    assert _read("vearch_tpu_torch", "tools", "lint", name) == ref


def test_the_port_lint_package_holds_no_other_file():
    port = sorted(f for f in os.listdir(os.path.join(PKG, "tools", "lint"))
                  if f.endswith((".py", ".txt")))
    assert port == LINT_FILES
    assert set(STATED_EDITS) <= set(LINT_FILES)


def test_every_configured_function_exists_in_the_port():
    """The entry points, serving functions and page-fault frames the
    rules key on name functions of the port's tree."""
    pt_core.run_paths([PKG])
    a = pt_callgraph.LAST
    have = {(f.ctx.path.replace(os.sep, "/"), f.qualname)
            for f in a.funcs.values()}
    wanted = [(s, q) for s, q, _kind in pt_config.INTERPROC_ENTRY_POINTS]
    wanted += list(pt_config.SERVING_PATH_FUNCTIONS)
    wanted += list(pt_config.VL502_PAGEFAULT_FUNCS)
    for suffix, qual in wanted:
        assert suffix.startswith("vearch_tpu_torch/"), suffix
        assert any(p.endswith(suffix) and q == qual for p, q in have), \
            (suffix, qual)
    assert len(a.entries) == len(pt_config.INTERPROC_ENTRY_POINTS)


# -- parity on the rule cases of tests/test_lint.py ----------------------------------

def _write(root, rel, source):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def _run(core, callgraph, root, rel, source, allow):
    path = _write(root, rel, source)
    allowlist = None
    if allow is not None:
        allow_path = root / "allow.txt"
        allow_path.write_text(allow)
        allowlist = core.Allowlist(str(allow_path))
    findings = core.run_paths([path], allowlist=allowlist)
    artifact = json.dumps(callgraph.LAST.lock_graph_artifact(),
                          sort_keys=True)
    return findings, artifact.replace(str(root), "<root>")


def _both(tmp_path, rel, source, allow=None):
    """Lint one snippet with each package under its own package path;
    returns ((ref findings, ref artifact), (port findings, port
    artifact)), the port's artifact rewritten back to the reference's
    names."""
    ref = _run(ref_core, ref_callgraph, tmp_path / "ref",
               rel.replace("PKG/", "vearch_tpu/"), source, allow)
    port = _run(pt_core, pt_callgraph, tmp_path / "port",
                rel.replace("PKG/", "vearch_tpu_torch/"), _to_port(source),
                allow)
    return ref, (port[0], _to_ref(port[1]))


def _key(findings):
    return sorted((f.rule, f.tag, f.line, f.suppressed, _to_ref(f.message))
                  for f in findings if f.rule != "VL000" or f.line)


def _hard(findings):
    return sorted(f.rule for f in findings if not f.suppressed)


# (path with PKG/ for the package root, snippet, allowlist text or None,
# the unsuppressed rules both must give)
RULE_CASES = {
    "vl101_hidden_dispatch_fires": ("cluster/sneaky.py", """\
        import jax

        def warm(fn):
            return jax.jit(fn)
        """, None, ["VL101"]),
    "vl101_silent_in_device_layers": ("PKG/ops/fine.py", """\
        import jax

        def warm(fn):
            return jax.jit(fn)
        """, None, []),
    "vl101_parallel_is_sanctioned": ("PKG/parallel/fine.py", """\
        import jax
        from jax.experimental.shard_map import shard_map

        def build(mesh, specs, body):
            return jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                                     out_specs=specs[0]))
        """, None, []),
    "vl101_shard_map_outside_fires": ("cluster/rogue_mesh.py", """\
        from jax.experimental.shard_map import shard_map

        def scan(mesh, specs, body):
            return shard_map(body, mesh=mesh, in_specs=specs,
                             out_specs=specs[0])
        """, None, ["VL101"]),
    "vl102_host_sync_in_serving_path_fires": ("PKG/cluster/ps.py", """\
        import numpy as np

        class PSServer:
            def _h_search(self, body):
                q = np.asarray(body["vectors"])
                return q

            def _h_other(self, body):
                return np.asarray(body)  # not a serving-path function
        """, None, ["VL102", "VL502"]),
    "vl102_inline_allow_suppresses": ("PKG/cluster/ps.py", """\
        import numpy as np

        class PSServer:
            def _h_search(self, body):
                q = np.asarray(body["vectors"])  # lint: allow[host-sync] wire payload normalization
                return q
        """, None, []),
    "vl103_redeclared_tier_literal_fires": ("PKG/engine/rogue.py", """\
        MY_ROW_BUCKETS = (8, 32)

        def pick(n):
            return min(b for b in MY_ROW_BUCKETS if b >= n)
        """, None, ["VL103"]),
    "vl103_import_and_inline_allow_pass": ("PKG/engine/fine.py", """\
        from vearch_tpu.ops import perf_model

        def pick(n):
            return perf_model.bucket_rows(n)

        HIST_BUCKETS = (1, 2, 4)  # lint: allow[bucket-drift] histogram bounds, not dispatch shapes
        """, None, []),
    "vl103_canonical_grid_drift_fires": ("PKG/ops/perf_model.py", """\
        ROW_BUCKETS = (8, 64, 256, 2048)
        FETCH_K_TIERS = (16, 64, 256, 1024)
        """, None, ["VL103"]),
    "vl103_canonical_grid_matching_is_clean": ("PKG/ops/perf_model.py", """\
        ROW_BUCKETS = (8, 64, 256, 1024)
        FETCH_K_TIERS = (16, 64, 256, 1024)
        """, None, []),
    "vl103_canonical_grid_missing_fires": ("PKG/ops/perf_model.py", """\
        ROW_BUCKETS = (8, 64, 256, 1024)
        """, None, ["VL103"]),
    "vl104_unattributed_billable_counter_fires": ("PKG/cluster/ps.py", """\
        class PSServer:
            def shed(self, lbl):
                self._shed_total.inc("search")
                self._killed_total.inc("deadline", lbl)
        """, None, ["VL104", "VL104"]),
    "vl104_space_argument_passes": ("PKG/cluster/ps.py", """\
        class PSServer:
            def shed(self, pid):
                space_lbl = self._acct.label(self._space_key(pid))
                self._shed_total.inc("search", space_lbl)
                self._killed_total.inc("deadline",
                                       self._space_key(pid))
                self._killed_total.inc("operator", SYSTEM_SPACE)
        """, None, []),
    "vl104_inline_allow_passes": ("PKG/cluster/router.py", """\
        class Router:
            def warm(self):
                self._shed_total.inc(  # lint: allow[space-attr] zero-fill label registration
                    "search", "other", by=0.0)
        """, None, []),
    "vl104_other_files_out_of_scope": ("PKG/cluster/master.py", """\
        class Master:
            def note(self):
                self._shed_total.inc("search")
        """, None, []),
    "vl105_mutation_without_staleness_hook_fires": ("PKG/cluster/ps.py", """\
        class PSServer:
            def _run_build(self, pid, rebuild):
                eng = self.engines[pid]
                if rebuild:
                    eng.rebuild_index()
                else:
                    eng.build_index()
        """, None, ["VL105"]),
    "vl105_hook_call_satisfies": ("PKG/cluster/ps.py", """\
        class PSServer:
            def _run_build(self, pid):
                self.engines[pid].build_index()
                self._quality.note_index_mutation(pid, "db/s", op="build")
        """, None, []),
    "vl105_engine_is_in_scope": ("PKG/engine/engine.py", """\
        class Engine:
            def absorb(self):
                self.index.build_index()
        """, None, ["VL105"]),
    "vl105_other_files_out_of_scope": ("PKG/bench/warm.py", """\
        class Warmer:
            def absorb(self, eng):
                eng.build_index()
        """, None, []),
    "vl105_def_line_allow_waives": ("PKG/cluster/ps.py", """\
        class PSServer:
            def _warm(self, eng):  # lint: allow[quality-staleness] offline warmup engine, never serves
                eng.build_index()
        """, None, []),
    "vl201_unguarded_mutation_fires": ("store.py", """\
        import threading

        class Store:
            _guarded_by = {"items": "_lock", "count": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self.items = {}
                self.count = 0  # __init__ is exempt

            def good(self, k, v):
                with self._lock:
                    self.items[k] = v
                    self.count += 1

            def bad(self, k):
                self.items.pop(k, None)
                self.count -= 1
        """, None, ["VL201", "VL201"]),
    "vl201_holds_pragma_trusted": ("store.py", """\
        import threading

        class Store:
            _guarded_by = {"count": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump_locked(self):  # lint: holds[_lock]
                self.count += 1
        """, None, []),
    "vl202_anonymous_thread_fires": ("bg.py", """\
        import threading

        def go(fn):
            threading.Thread(target=fn, daemon=True).start()
            threading.Thread(target=fn, daemon=True, name="ok").start()
        """, None, ["VL202"]),
    "vl203_wall_clock_fires_and_monotonic_passes": ("timing.py", """\
        import time
        import time as _time

        def latency():
            t0 = time.time()
            t1 = _time.time()
            t2 = time.monotonic()
            return t0, t1, t2
        """, None, ["VL203", "VL203"]),
    "vl301_bare_except_fires": ("anything.py", """\
        def f():
            try:
                return 1
            except:
                return None
        """, None, ["VL301"]),
    "vl302_swallowed_except_in_raft_fires": ("PKG/cluster/raft.py", """\
        def apply(entries, log):
            for e in entries:
                try:
                    e()
                except Exception:
                    pass
                try:
                    e()
                except Exception as exc:  # visible: logged
                    log.warning("apply failed: %s", exc)
        """, None, ["VL302"]),
    "vl302_only_in_critical_modules": ("PKG/cluster/router.py", """\
        def f(e):
            try:
                e()
            except Exception:
                pass
        """, None, []),
    "vl000_reasonless_pragma_is_a_finding": ("timing.py", """\
        import time

        def f():
            return time.time()  # lint: allow[wall-clock]
        """, None, ["VL000"]),
    "vl000_allowlist_suppresses_and_unused_entries_fail": (
        "cluster/timing.py", """\
        import time

        def f():
            return time.time()
        """, "VL203 cluster/timing.py fixture proves file-scoped "
             "suppression\nVL101 cluster/gone.py this entry matches "
             "nothing\n", ["VL000"]),
    "vl501_laundered_dispatch_fires_through_two_hops": (
        "PKG/cluster/router.py", """\
        import jax

        class RouterServer:
            def _h_search(self, body, parts):
                return self._route(body)

            def _route(self, body):
                return _prep(body)

        def _prep(body):
            fn = jax.jit(lambda x: x)  # lint: allow[dispatch] offline tooling claim
            return fn(body)
        """, None, ["VL501"]),
    "vl502_blocking_open_three_frames_deep": ("PKG/cluster/router.py", """\
        class RouterServer:
            def _h_search(self, body, parts):
                return self._impl(body)

            def _impl(self, body):
                return _load(body)

        def _load(body):
            with open("/tmp/x") as f:
                return f.read()
        """, None, ["VL502"]),
    "vl502_pragma_at_offending_frame_suppresses": (
        "PKG/cluster/router.py", """\
        class RouterServer:
            def _h_search(self, body, parts):
                return _load(body)

        def _load(body):
            # lint: allow[serving-blocking] fixture: startup-only manifest read
            with open("/tmp/x") as f:
                return f.read()
        """, None, []),
    "vl502_pragma_at_entry_does_not_launder": ("PKG/cluster/router.py", """\
        class RouterServer:
            def _h_search(self, body, parts):  # lint: allow[serving-blocking] fixture: wrong frame
                return _load(body)

        def _load(body):
            with open("/tmp/x") as f:
                return f.read()
        """, None, ["VL502"]),
    "vl503_constructed_lock_cycle_fires": ("PKG/cluster/fixlocks.py", """\
        from vearch_tpu.tools import lockcheck

        _a = lockcheck.make_lock("fix.a")
        _b = lockcheck.make_lock("fix.b")

        def one():
            with _a:
                with _b:
                    pass

        def two():
            with _b:
                with _a:
                    pass
        """, None, ["VL503"]),
    "vl503_consistent_order_is_clean": ("PKG/cluster/fixlocks.py", """\
        from vearch_tpu.tools import lockcheck

        _a = lockcheck.make_lock("fix.a")
        _b = lockcheck.make_lock("fix.b")

        def one():
            with _a:
                with _b:
                    pass

        def two():
            with _a:
                with _b:
                    pass
        """, None, []),
    "vl503_transitive_acquire_completes_cycle": ("PKG/cluster/fixlocks.py", """\
        from vearch_tpu.tools import lockcheck

        _a = lockcheck.make_lock("fix.a")
        _b = lockcheck.make_lock("fix.b")

        def one():
            with _a:
                with _b:
                    pass

        def _inner():
            with _a:
                pass

        def two():
            with _b:
                _inner()
        """, None, ["VL503"]),
    "vl504_dropped_deadline_rpc_fires": ("PKG/cluster/router.py", """\
        from vearch_tpu.cluster import rpc

        class RouterServer:
            def _h_search(self, body, parts):
                return self._scatter(body)

            def _scatter(self, body):
                return rpc.call("addr", "POST", "/ps/doc/search", body)
        """, None, ["VL504"]),
    "vl504_timeout_kwarg_or_body_deadline_satisfies": (
        "PKG/cluster/router.py", """\
        from vearch_tpu.cluster import rpc

        class RouterServer:
            def _h_search(self, body, parts):
                rpc.call("addr", "POST", "/p", body, timeout=1.0)
                return rpc.call("addr", "POST", "/p",
                                {"deadline_ms": body.get("deadline_ms")})
        """, None, []),
    "vl50x_out_of_reach_code_is_silent": ("PKG/cluster/offline.py", """\
        from vearch_tpu.cluster import rpc

        def backup_tool(path):
            with open(path) as f:
                return rpc.call("addr", "POST", "/admin", f.read())
        """, None, []),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_case_gives_the_reference_findings(tmp_path, case):
    rel, source, allow, want = RULE_CASES[case]
    (ref, ref_art), (port, port_art) = _both(tmp_path, rel, source, allow)
    assert _hard(ref) == want, [f.render() for f in ref]
    assert _hard(port) == want, [f.render() for f in port]
    assert _key(port) == _key(ref)
    assert port_art == ref_art


def test_vl501_reports_the_chain_and_keeps_the_lexical_waiver(tmp_path):
    rel, source, allow, _ = RULE_CASES[
        "vl501_laundered_dispatch_fires_through_two_hops"]
    (ref, _), (port, _) = _both(tmp_path, rel, source, allow)
    for findings in (ref, port):
        msg = next(f for f in findings if f.rule == "VL501").message
        assert "_h_search" in msg and "_route" in msg and "_prep" in msg
        assert [f.suppressed for f in findings if f.rule == "VL101"] == [True]


# -- parity on the call-graph cases --------------------------------------------------

def _analysis(core, callgraph, root, files):
    ctxs = []
    for rel, src in files.items():
        path = _write(root, rel, src)
        with open(path) as f:
            ctxs.append(core.FileContext(path, f.read()))
    return callgraph.build(ctxs)


def _reach(a, kind):
    return {q.split(":", 1)[1] for q in a.reachable(kind)}


def _check_self_methods(a, callgraph):
    reach = _reach(a, "search")
    assert "RouterServer._h_search.timed" in reach
    assert "RouterServer._deep" in reach


def _check_cross_module(a, callgraph):
    reach = _reach(a, "search")
    assert "work" in reach and "direct" in reach


def _check_stoplist(a, callgraph):
    fn = next(f for f in a.funcs.values()
              if f.qualname == "RouterServer._h_search")
    assert "fanout" not in {r.kind for r in fn.calls}
    assert any(r.kind == "dynamic" and (r.dotted or "").endswith(".get")
               for r in fn.calls)


def _check_lock_prefix(a, callgraph):
    art = a.lock_graph_artifact()
    assert art["cycles"] == []
    assert callgraph.edge_covered(art, "fix.ps.flush3", "fix.ps._lock")
    assert not callgraph.edge_covered(art, "fix.ps._lock", "other.lock")


def _check_return_annotation(a, callgraph):
    fn = next(f for f in a.funcs.values() if f.qualname == "PS.flush")
    saves = [r for r in fn.calls
             if any(t.endswith("RaftNode.save") for t in r.targets)]
    assert len(saves) == 2 and all(r.kind == "resolved" for r in saves)
    assert callgraph.edge_covered(a.lock_graph_artifact(), "fixann.flush",
                                  "fixann.apply")


def _check_ctor_callback(a, callgraph):
    art = a.lock_graph_artifact()
    assert art["cycles"] == []
    assert callgraph.edge_covered(art, "fixcb.node", "fixcb.stats")
    fn = next(f for f in a.funcs.values() if f.qualname == "Node.commit")
    assert any(r.kind == "callback" for r in fn.calls)


def _check_param_callback(a, callgraph):
    art = a.lock_graph_artifact()
    assert art["cycles"] == []
    assert callgraph.edge_covered(art, "fixpc.cache", "fixpc.tier")


def _check_no_laundering(a, callgraph):
    search = _reach(a, "search")
    assert "RouterServer._search_impl" in search
    assert "RouterServer._upsert_impl" not in search


CALLGRAPH_CASES = {
    "resolves_self_methods_and_nested_defs": (_check_self_methods, {
        "PKG/cluster/router.py": """\
        class RouterServer:
            def _h_search(self, body, parts):
                def timed():
                    return self._deep(body)
                return timed()

            def _deep(self, body):
                return body
        """}),
    "resolves_cross_module_imports": (_check_cross_module, {
        "PKG/cluster/router.py": """\
            from vearch_tpu.cluster import helpers
            from vearch_tpu.cluster.helpers import direct

            class RouterServer:
                def _h_search(self, body, parts):
                    helpers.work(body)
                    return direct(body)
            """,
        "PKG/cluster/helpers.py": """\
            def work(body):
                return body

            def direct(body):
                return body
            """}),
    "stoplisted_names_land_in_unresolved_bucket": (_check_stoplist, {
        "PKG/cluster/router.py": """\
        class RouterServer:
            def _h_search(self, body, parts):
                handle = body["h"]
                return handle.get("x")
        """}),
    "lock_graph_artifact_coverage_semantics": (_check_lock_prefix, {
        "PKG/cluster/fix.py": """\
        from vearch_tpu.tools import lockcheck

        class PS:
            def __init__(self):
                self._lock = lockcheck.make_lock("fix.ps._lock")
                self._fl = {}

            def _flush_lock(self, pid):
                with self._lock:
                    return self._fl.setdefault(
                        pid, lockcheck.make_lock(f"fix.ps.flush{pid}"))

            def flush(self, pid):
                with self._flush_lock(pid):
                    with self._lock:
                        pass
        """}),
    "types_locals_from_return_annotation": (_check_return_annotation, {
        "PKG/cluster/fixann.py": """\
        from vearch_tpu.tools import lockcheck

        class RaftNode:
            def __init__(self):
                self._apply_lock = lockcheck.make_lock("fixann.apply")

            def save(self):
                with self._apply_lock:
                    pass

        class PS:
            def __init__(self):
                self._flush = lockcheck.make_lock("fixann.flush")
                self.nodes: dict[int, RaftNode] = {}

            def _node(self, pid) -> RaftNode:
                return self.nodes[pid]

            def flush(self, pid):
                node = self._node(pid)
                with self._flush:
                    node.save()
                    self.nodes[pid].save()
        """}),
    "ctor_injected_callback_orders_at_invocation": (_check_ctor_callback, {
        "PKG/cluster/fixcb.py": """\
        from vearch_tpu.tools import lockcheck

        class Node:
            def __init__(self, apply_fn):
                self._lock = lockcheck.make_lock("fixcb.node")
                self.apply_fn = apply_fn

            def commit(self, op):
                with self._lock:
                    self.apply_fn(op)

        class PS:
            def __init__(self):
                self._stats = lockcheck.make_lock("fixcb.stats")
                self.node = Node(apply_fn=lambda op: self._apply(op))

            def _apply(self, op):
                with self._stats:
                    return op
        """}),
    "param_callback_through_factory": (_check_param_callback, {
        "PKG/index/fixpc.py": """\
        from vearch_tpu.tools import lockcheck

        class Cache:
            def __init__(self):
                self._lock = lockcheck.make_lock("fixpc.cache")

            def resolve(self, fetch):
                with self._lock:
                    return fetch(1)

        class Tier:
            def __init__(self):
                self._lock = lockcheck.make_lock("fixpc.tier")

            def get(self, b):
                with self._lock:
                    return b

        class Index:
            def __init__(self):
                self.cache = Cache()
                self.tier = Tier()

            def _make_fetch(self):
                def fetch(b):
                    return self.tier.get(b)
                return fetch

            def lookup(self):
                fetch = self._make_fetch()
                return self.cache.resolve(fetch)
        """}),
    "callback_binding_does_not_launder_reachability": (
        _check_no_laundering, {
            "PKG/cluster/router.py": """\
        class Retrier:
            def __init__(self):
                self.op = None

            def run(self, op):
                self.op = op
                return self.op()

        class RouterServer:
            def _h_search(self, body, parts):
                r = Retrier()
                return r.run(self._search_impl)

            def _h_upsert(self, body, parts):
                r = Retrier()
                return r.run(self._upsert_impl)

            def _search_impl(self):
                return 1

            def _upsert_impl(self):
                return 2
        """}),
}


def _calls(a):
    return sorted((f.qualname, r.line, r.kind, r.dotted)
                  for f in a.funcs.values() for r in f.calls)


@pytest.mark.parametrize("case", sorted(CALLGRAPH_CASES))
def test_callgraph_case_resolves_as_the_reference(tmp_path, case):
    check, files = CALLGRAPH_CASES[case]
    ref = _analysis(ref_core, ref_callgraph, tmp_path / "ref", {
        rel.replace("PKG/", "vearch_tpu/"): src
        for rel, src in files.items()})
    port = _analysis(pt_core, pt_callgraph, tmp_path / "port", {
        rel.replace("PKG/", "vearch_tpu_torch/"): _to_port(src)
        for rel, src in files.items()})
    check(ref, ref_callgraph)
    check(port, pt_callgraph)
    for kind in ("search", "write"):
        assert _reach(port, kind) == _reach(ref, kind)
    assert [(q, ln, k, _to_ref(d or "")) for q, ln, k, d in _calls(port)] \
        == [(q, ln, k, d or "") for q, ln, k, d in _calls(ref)]
    art = {}
    for name, a, root in (("ref", ref, tmp_path / "ref"),
                          ("port", port, tmp_path / "port")):
        text = json.dumps(a.lock_graph_artifact(), sort_keys=True)
        art[name] = _to_ref(text.replace(str(root), "<root>"))
    assert art["port"] == art["ref"]


# -- PyTorch's constructs: the stated departures ---------------------------------------

TORCH_CASES = {
    # VL102 / VL502 in a serving function
    "cpu_copy_in_serving_path": ("PKG/cluster/ps.py", """\
        class PSServer:
            def _h_search(self, body):
                t = self._engine_scores(body)
                return t.cpu()  # port: VL102 VL502
        """),
    "item_in_serving_path": ("PKG/cluster/ps.py", """\
        class PSServer:
            def _h_search(self, body):
                t = self._engine_scores(body)
                return t.item()  # both: VL102 VL502
        """),
    "synchronize_in_serving_path": ("PKG/cluster/ps.py", """\
        import torch

        class PSServer:
            def _h_search(self, body):
                torch.cuda.synchronize()  # port: VL102 VL502
                ev = torch.cuda.Event()
                ev.synchronize()  # port: VL102 VL502
                torch.cuda.current_stream().synchronize()  # port: VL102 VL502
                return body
        """),
    "asarray_of_a_tensor_in_serving_path": ("PKG/cluster/ps.py", """\
        import numpy as np
        import torch

        class PSServer:
            def _h_search(self, body):
                t = torch.as_tensor(body["s"])
                return np.asarray(t)  # both: VL102 VL502
        """),
    "tolist_and_numpy_of_a_tensor": ("PKG/cluster/ps.py", """\
        import torch

        class PSServer:
            def _h_search(self, body):
                top = torch.topk(torch.as_tensor(body["s"]), 3).indices.tolist()  # port: VL102 VL502
                rows = self.rows.detach().numpy()  # port: VL102 VL502
                both = self.rows.cpu().tolist()  # port: VL102 VL102 VL502 VL502
                return top, rows, both
        """),
    # the router's merge (cluster/router.py): numpy arrays' .tolist()
    "numpy_tolist_stays_silent": ("PKG/cluster/router.py", """\
        import numpy as np

        class RouterServer:
            def _h_search(self, body, parts):
                return self._search_impl(body, parts)

            def _search_impl(self, body, parts):
                scores = np.asarray(parts["scores"])  # lint: allow[host-sync] wire payload normalization
                order = np.argsort(-scores, kind="stable")[:3]
                top = scores[order].tolist()
                offs = np.cumsum([0] + [len(ks) for ks in parts["keys"]])
                flat = np.concatenate(parts["flat"])
                rows = [flat[offs[i]:offs[i + 1]].tolist()
                        for i in range(len(parts["keys"]))]
                return [order.tolist(), top, rows]
        """),
    # VL101: programs outside the device layers
    "register_op_outside_device_layers": ("PKG/cluster/merge.py", """\
        from vearch_tpu.ops import perf_model

        @perf_model.register_op("cluster.merge")  # port: VL101 VL101
        def merge(x):
            return x
        """),
    "register_op_in_a_device_layer": ("PKG/tiering/fine.py", """\
        from vearch_tpu.ops import perf_model

        @perf_model.register_op("tiering.fine")
        def scatter(x):
            return x
        """),
    "torch_programs_outside_device_layers": ("PKG/cluster/warm.py", """\
        import json
        import re

        import torch
        from torch.utils import cpp_extension

        from vearch_tpu.ops._cuda_build import CudaLibrary, HostExtension

        PAT = re.compile("x")
        LIB = CudaLibrary("k.cu", {})  # port: VL101
        NATIVE = HostExtension("n.cpp", "n")

        def warm(fn, path):
            cfg = json.load(open(path))
            g = torch.cuda.CUDAGraph()  # port: VL101
            ext = cpp_extension.load(name="e", sources=[path])  # port: VL101
            with torch.cuda.graph(g):  # port: VL101
                jitted = torch.jit.script(fn)  # port: VL101
            return torch.compile(fn), cfg, ext, jitted  # port: VL101
        """),
    # VL501 / VL502 through the call graph
    "torch_compile_laundered_onto_a_search_path": ("PKG/cluster/router.py", """\
        import torch

        class RouterServer:
            def _h_search(self, body, parts):
                return self._route(body)

            def _route(self, body):
                return torch.compile(body)  # lint: allow[dispatch] offline tooling claim  # port: VL501
        """),
    "cpu_copy_two_frames_below_a_search_handler": ("PKG/cluster/router.py", """\
        class RouterServer:
            def _h_search(self, body, parts):
                return self._impl(body)

            def _impl(self, body):
                return _host(body["t"])

        def _host(t):
            return t.cpu()  # port: VL502
        """),
    # engine/ is sync-exempt for VL502 and _finish is no serving function
    "cpu_copy_in_a_sync_exempt_layer": ("PKG/engine/engine.py", """\
        class Engine:
            def search(self, req):
                return self._finish(req)

            def _finish(self, req):
                return req.scores.cpu().numpy()
        """),
}

_MARK = re.compile(r"#\s*(both|port):\s*((?:VL\d+\s*)+)$")


def _hard_lines(findings):
    return sorted((f.rule, f.line) for f in findings if not f.suppressed)


def _marked(source: str, linters: tuple[str, ...]):
    out = []
    for i, text in enumerate(textwrap.dedent(source).splitlines(), start=1):
        m = _MARK.search(text)
        if m and m.group(1) in linters:
            out += [(rule, i) for rule in m.group(2).split()]
    return sorted(out)


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_construct_case(tmp_path, case):
    rel, source = TORCH_CASES[case]
    (ref, _), (port, _) = _both(tmp_path, rel, source)
    assert _hard_lines(port) == _marked(source, ("both", "port")), \
        [f.render() for f in port]
    assert _hard_lines(ref) == _marked(source, ("both",)), \
        [f.render() for f in ref]


def test_torch_sync_and_dispatch_messages_name_the_construct(tmp_path):
    rel, source = TORCH_CASES["synchronize_in_serving_path"]
    _, (port, _) = _both(tmp_path / "s", rel, source)
    msgs = {f.message for f in port if f.rule == "VL102"}
    assert any("torch.cuda.synchronize(...)" in m for m in msgs)
    assert any("ev.synchronize(...)" in m for m in msgs)
    rel, source = TORCH_CASES["cpu_copy_two_frames_below_a_search_handler"]
    _, (port, _) = _both(tmp_path / "c", rel, source)
    msg = next(f.message for f in port if f.rule == "VL502")
    assert "`.cpu()`" in msg
    assert "RouterServer._h_search -> RouterServer._impl -> _host" in msg


# -- the gate and the CLI -------------------------------------------------------------

def _cli(*args):
    return subprocess.run([sys.executable, "-m", LINT, *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)


def test_port_package_is_lint_clean():
    out = _cli(PKG)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert re.fullmatch(r"vearch-lint: 0 finding\(s\), \d+ allowed with "
                        r"reasons", last), last


def test_list_rules_names_every_rule():
    out = _cli("--list-rules")
    assert out.returncode == 0
    ref = subprocess.run(
        [sys.executable, "-m", "vearch_tpu.tools.lint", "--list-rules"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.stdout == ref.stdout
    for rid in ("VL101", "VL102", "VL103", "VL104", "VL105", "VL201",
                "VL202", "VL203", "VL301", "VL302", "VL401", "VL501",
                "VL502", "VL503", "VL504"):
        assert rid in out.stdout, rid


def test_cli_json_and_lock_graph_modes():
    out = _cli(PKG, "--json", "--show-allowed")
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["hard"] == 0 and doc["allowed"] > 0
    assert all(f["suppressed"] and f["reason"] for f in doc["findings"])
    assert len(doc["findings"]) == doc["allowed"]

    out = _cli(PKG, "--lock-graph")
    assert out.returncode == 0, out.stdout + out.stderr
    art = json.loads(out.stdout)
    assert art["cycles"] == []
    assert art["edges"], "the port's cluster plane nests locks"
    ids = {n["id"] for n in art["nodes"]}
    for e in art["edges"]:
        assert e["first"] in ids and e["then"] in ids
        assert e["site"].split(":")[0].startswith(PKG + os.sep)


def test_cli_changed_only_filters_to_diffed_files():
    out = _cli(PKG, "--changed-only", "no-such-ref-xyzzy")
    assert out.returncode == 2
    assert "cannot diff" in out.stderr


def test_whole_package_single_parse_under_budget(monkeypatch):
    parses = []
    real = pt_core.FileContext

    class Counting(real):
        def __init__(self, path, source):
            parses.append(path)
            super().__init__(path, source)

    monkeypatch.setattr(pt_core, "FileContext", Counting)
    t0 = time.monotonic()
    pt_core.run_paths([PKG])
    elapsed = time.monotonic() - t0
    assert elapsed < 30.0, f"package lint took {elapsed:.1f}s"
    assert parses, "no files parsed?"
    dup = {p for p in parses if parses.count(p) > 1}
    assert not dup, f"files parsed more than once: {sorted(dup)[:5]}"
