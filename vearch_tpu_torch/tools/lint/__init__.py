"""vearch-lint: project-invariant static analysis for vearch-tpu.

Run: ``python -m vearch_tpu_torch.tools.lint [paths...]`` (defaults to the
installed package). Rule catalogue and the allowlist workflow are
documented in docs/STATIC_ANALYSIS.md.
"""

from vearch_tpu_torch.tools.lint.core import (
    Allowlist,
    FileContext,
    Finding,
    Rule,
    RULES,
    run_paths,
)

__all__ = [
    "Allowlist",
    "FileContext",
    "Finding",
    "Rule",
    "RULES",
    "run_paths",
    "default_allowlist_path",
]


def default_allowlist_path() -> str:
    import os

    return os.path.join(os.path.dirname(__file__), "allowlist.txt")
