"""Observability-drift rule (VL401).

The registries of record are the metric registrations, span factories,
and span tags in the source tree; docs/OBSERVABILITY.md must document
exactly that set, both directions. An undocumented metric is invisible
to the operator; a documented-but-unregistered one lies to them
mid-incident, which is worse.

The port's copy of vearch_tpu/tools/lint/rules_obs.py, and the one home
of the port's drift helpers: the doctor's ``obs_docs`` check
(obs/doctor.py) reads them. The port's check reads docs/OBSERVABILITY.md
and the port's own docs/OBSERVABILITY_TORCH.md as one (``doc_paths``,
``drift_failures_over``).

Names are compared after normalizing dynamic segments: an f-string
``{tag}`` in source and a ``{tag}``/``<tag>`` placeholder in the doc
both become ``*``.
"""

from __future__ import annotations

import fnmatch
import os
import re

from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register

# metric registration call sites — counter/gauge/histogram and the
# callback variants — with the name literal possibly on the next line.
# Anchored on the quote right after the paren so the Registry method
# definitions themselves don't match.
_METRIC_RE = re.compile(
    r"\.(?:counter|gauge|histogram|callback_gauge|callback_counter)"
    r"\(\s*[\"']([A-Za-z_][\w]*)[\"']",
    re.S,
)

# post-creation span tags — set_tag with a literal key — mark
# per-request facts the operator greps for mid-incident; every literal
# key must appear backticked in the doc. One-directional: single-word
# doc backticks are too generic to demand a registration behind each.
_TAG_RE = re.compile(r"\.set_tag\(\s*[\"']([a-z_]+)[\"']")

# span factories — tracer span/record calls with a (possibly
# f-string) name literal — plus the engine's phase rows appended to
# `phases`/`spans` lists, which the PS replays as retroactive spans.
_SPAN_RES = [
    re.compile(r"\.span\(\s*f?[\"']([a-z_.{}]+)[\"']", re.S),
    re.compile(r"\.record\(\s*f?[\"']([a-z_.{}]+)[\"']", re.S),
    re.compile(r"phases\.append\(\(\s*f?[\"']([a-z_.{}]+)[\"']", re.S),
    re.compile(r"spans\.append\(\[\s*f?[\"']([a-z_.{}]+)[\"']", re.S),
    re.compile(r"spans\.extend\(\s*\[\s*f?[\"']([a-z_.{}]+)[\"']", re.S),
]


def repo_root() -> str:
    import vearch_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        vearch_tpu_torch.__file__)))


def default_doc_path() -> str:
    return os.path.join(repo_root(), "docs", "OBSERVABILITY.md")


def doc_paths() -> list[str]:
    """The docs the port's drift check reads as one: the shared
    docs/OBSERVABILITY.md and the port's own docs/OBSERVABILITY_TORCH.md,
    which lists what only the port emits."""
    return [default_doc_path(),
            os.path.join(repo_root(), "docs", "OBSERVABILITY_TORCH.md")]


def _normalize(name: str) -> str:
    return re.sub(r"[{<][^}>]*[}>]", "*", name)


def names_from_text(text: str) -> tuple[set[str], set[str], set[str]]:
    """(metrics, spans, tags) registered/emitted by one source file."""
    metrics = set(_METRIC_RE.findall(text))
    tags = set(_TAG_RE.findall(text))
    spans: set[str] = set()
    for rx in _SPAN_RES:
        spans.update(_normalize(n) for n in rx.findall(text))
    return metrics, spans, tags


def source_names(src_dir: str) -> tuple[set[str], set[str], set[str]]:
    """Walk a source tree for every metric/span/tag name."""
    metrics: set[str] = set()
    spans: set[str] = set()
    tags: set[str] = set()
    for root, _dirs, files in os.walk(src_dir):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                m, s, t = names_from_text(f.read())
            metrics |= m
            spans |= s
            tags |= t
    return metrics, spans, tags


def doc_names(doc_path: str) -> tuple[set[str], set[str]]:
    """Backticked tokens in the doc, split into metric-shaped
    (prometheus identifier) and span-shaped (dotted) names. Prose
    backticks (`trace: true`, file paths, field names) match neither
    shape and are ignored."""
    with open(doc_path) as f:
        text = f.read()
    metrics: set[str] = set()
    spans: set[str] = set()
    for tok in re.findall(r"`([^`\n]+)`", text):
        if re.fullmatch(r"(?:vearch|tracing)_[a-z0-9_]+", tok):
            metrics.add(tok)
        elif re.fullmatch(r"[a-z_]+(?:\.[a-z_{}<>]+)+", tok):
            spans.add(_normalize(tok))
    return metrics, spans


def drift_failures(
    src_metrics: set[str], src_spans: set[str], src_tags: set[str],
    doc_path: str,
) -> list[str]:
    doc_metrics, doc_spans = doc_names(doc_path)
    with open(doc_path) as f:
        doc_words = set(re.findall(r"`([a-z_]+)`", f.read()))
    # keep only doc tokens whose first segment matches an emitted span
    # family — drops dotted prose like `dispatches.tags` (a JSON field,
    # not a span) without a hand-maintained prefix list
    span_roots = {s.split(".", 1)[0] for s in src_spans}
    doc_spans = {s for s in doc_spans if s.split(".", 1)[0] in span_roots}

    failures = []
    for name in sorted(src_metrics - doc_metrics):
        failures.append(f"metric registered but undocumented: {name}")
    for name in sorted(doc_metrics - src_metrics):
        failures.append(f"metric documented but not registered: {name}")
    for name in sorted(src_spans - doc_spans):
        failures.append(f"span emitted but undocumented: {name}")
    for name in sorted(doc_spans - src_spans):
        failures.append(f"span documented but never emitted: {name}")
    for name in sorted(src_tags - doc_words):
        failures.append(f"span tag set but undocumented: {name}")
    return failures


def drift_failures_over(
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


def check_package(src_dir: str | None = None,
                  doc_path: str | None = None) -> list[str]:
    """The whole-package drift check the script CLI runs: returns the
    failure lines (empty = in sync)."""
    src = src_dir or os.path.join(repo_root(), "vearch_tpu_torch")
    docs = [doc_path] if doc_path else doc_paths()
    metrics, spans, tags = source_names(src)
    return drift_failures_over(metrics, spans, tags, docs)


def summary(src_dir: str | None = None) -> str:
    src = src_dir or os.path.join(repo_root(), "vearch_tpu_torch")
    metrics, spans, tags = source_names(src)
    return (f"obs docs in sync: {len(metrics)} metrics, "
            f"{len(spans)} span families, {len(tags)} span tags")


def _check_project(contexts: list[FileContext]):
    # only meaningful on a whole-package scan: the bidirectional check
    # needs every registration in view, or documented names would look
    # stale. cluster/metrics.py anchors "the package is in the scan".
    if not any(c.path.replace("\\", "/").endswith("cluster/metrics.py")
               for c in contexts):
        return
    doc = default_doc_path()
    if not os.path.exists(doc):
        yield Finding("VL401", "obs-drift", doc, 0,
                      "docs/OBSERVABILITY.md missing")
        return
    metrics: set[str] = set()
    spans: set[str] = set()
    tags: set[str] = set()
    for c in contexts:
        m, s, t = names_from_text(c.source)
        metrics |= m
        spans |= s
        tags |= t
    for failure in drift_failures_over(metrics, spans, tags, doc_paths()):
        yield Finding("VL401", "obs-drift", doc, 0, failure)


register(Rule(
    id="VL401", tag="obs-drift",
    doc="metric/span/tag names in source and OBSERVABILITY.md stay in "
        "sync, both directions",
    check_project=_check_project,
))
