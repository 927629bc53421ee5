"""Dispatch-hygiene rules.

VL101 — dispatch-creating constructs (`jax.jit`, `pallas_call`,
`pmap`, `shard_map`) may only appear in the device layers
(`ops/`, `engine/`). A jit hidden in the cluster plane creates device
programs the perf model never counted — the zero-retrace and
dispatch-count CI gates (docs/PERF.md) only hold if every program is
born where the model can see it.

VL102 — host-device sync points (`block_until_ready`, `device_get`,
`.item()`, `np.asarray` / `np.array` materialisation) inside the
configured serving-path functions. Each one stalls the request thread
on device completion; the intended ones (terminal result
materialisation) carry an inline `allow[host-sync]` reason.

The port's copy of vearch_tpu/tools/lint/rules_dispatch.py. Both rules
also read PyTorch's constructs (tools/lint/config.py): `register_op`,
`CudaLibrary`, `torch.compile`, `torch.jit.script` / `trace`,
`torch.cuda.CUDAGraph` / `graph` and `cpp_extension.load` /
`load_inline` create programs (`is_dispatch`); `.cpu()`, any
`.synchronize()`, and `.tolist()` / `.numpy()` on a visible tensor are
host syncs (`torch_sync_hit`).
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain as 'a.b.c'; None for anything else."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _qualname(ctx: FileContext, func: ast.AST) -> str:
    names = [func.name]
    for anc in ctx.ancestors(func):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(anc.name)
    return ".".join(reversed(names))


def is_dispatch(name: str) -> bool:
    """Whether a call's or decorator's dotted name creates a device
    program: the reference's constructs and the port's by last name,
    the port's generic-named ones by dotted suffix."""
    last = name.split(".")[-1]
    if last in config.DISPATCH_CONSTRUCTS or \
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
    if attr in config.TORCH_MATERIALIZE_METHODS and not call.args \
            and _visibly_tensor(call.func.value):
        return f".{attr}() of a tensor"
    return None


def _check_dispatch(ctx: FileContext):
    path = _norm(ctx.path)
    if any(pkg in path for pkg in config.DISPATCH_PACKAGES):
        return
    for node in ast.walk(ctx.tree):
        name = None
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                dname = _dotted(target)
                if dname and is_dispatch(dname):
                    name = dname
                    node = dec  # report the decorator line
                    break
        if not name:
            continue
        if not is_dispatch(name):
            continue
        # bare `jit` must come from jax to count; attribute forms
        # (jax.jit, pl.pallas_call, jax.experimental...) always count
        line = node.lineno
        ok, reason = ctx.allowed(line, "dispatch")
        yield Finding(
            "VL101", "dispatch", ctx.path, line,
            f"dispatch-creating construct `{name}` outside the device "
            "layers (ops/, engine/) — the perf model cannot see "
            "programs born here",
            suppressed=ok, reason=reason,
        )


def _check_host_sync(ctx: FileContext):
    path = _norm(ctx.path)
    serving: list[ast.AST] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qn = _qualname(ctx, node)
            for suffix, want in config.SERVING_PATH_FUNCTIONS:
                if path.endswith(suffix) and qn == want:
                    serving.append(node)
    for func in serving:
        fa, freason = ctx.func_allowed(func, "host-sync")
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            hit = None
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in config.HOST_SYNC_METHODS and not node.args:
                    hit = f".{attr}()"
                elif attr in config.HOST_SYNC_CALLS:
                    base = _dotted(node.func.value)
                    if base in ("np", "numpy", "_np", "jax"):
                        hit = f"{base}.{attr}(...)"
            if hit is None:
                hit = torch_sync_hit(node)
            if hit is None:
                continue
            line = node.lineno
            ok, reason = ctx.allowed(line, "host-sync")
            if not ok and fa:
                ok, reason = True, freason
            yield Finding(
                "VL102", "host-sync", ctx.path, line,
                f"host-device sync `{hit}` inside serving-path "
                f"function `{func.name}` — stalls the request on "
                "device completion; justify inline if intended",
                suppressed=ok, reason=reason,
            )


register(Rule(
    id="VL101", tag="dispatch",
    doc="jit/pallas_call/pmap/shard_map only in ops/ and engine/",
    check_file=_check_dispatch,
))

register(Rule(
    id="VL102", tag="host-sync",
    doc="no unjustified host-device sync inside serving-path functions",
    check_file=_check_host_sync,
))
