"""CLI: python -m vearch_tpu_torch.tools.lint [paths...]

Exit 0 when every finding is suppressed with a reason (inline pragma
or allowlist entry); exit 1 otherwise. `--show-allowed` prints the
suppressed findings too, so the waiver inventory stays reviewable.

`--json` emits the findings as a machine-readable object (CI
annotators); `--changed-only <git-ref>` still analyzes the WHOLE
package (the interprocedural rules need the full call graph) but only
*reports* findings in files changed since the ref; `--lock-graph`
prints the static lock-order artifact the stress suite diffs runtime
lockcheck edges against.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from vearch_tpu_torch.tools.lint import (
    Allowlist, RULES, default_allowlist_path, run_paths,
)


def _changed_files(ref: str) -> set[str] | None:
    """Absolute paths of files changed vs `ref` (committed, staged and
    unstaged), or None when git cannot answer."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    top = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        capture_output=True, text=True,
    ).stdout.strip()
    return {
        os.path.abspath(os.path.join(top, line.strip()))
        for line in out.stdout.splitlines() if line.strip()
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="vearch-lint")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the vearch_tpu_torch "
                         "package)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: the checked-in "
                         "tools/lint/allowlist.txt)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="ignore the allowlist (show everything)")
    ap.add_argument("--show-allowed", action="store_true",
                    help="also print suppressed findings with reasons")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--changed-only", metavar="GIT_REF", default=None,
                    help="analyze the whole package but report only "
                         "findings in files changed since GIT_REF")
    ap.add_argument("--lock-graph", action="store_true",
                    help="print the static lock-order graph artifact "
                         "(JSON) instead of findings")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    # importing run_paths' rule modules happens inside run_paths; for
    # --list-rules force it eagerly
    from vearch_tpu_torch.tools.lint import (  # noqa: F401
        rules_accounting, rules_buckets, rules_dispatch, rules_errors,
        rules_interproc, rules_locks, rules_obs, rules_quality,
    )

    if args.list_rules:
        for r in RULES:
            print(f"{r.id}  allow[{r.tag}]  {r.doc}")
        return 0

    paths = args.paths
    if not paths:
        import vearch_tpu_torch

        paths = [os.path.dirname(os.path.abspath(vearch_tpu_torch.__file__))]

    allowlist = None
    if not args.no_allowlist:
        allowlist = Allowlist(args.allowlist or default_allowlist_path())

    findings = run_paths(paths, allowlist=allowlist)

    if args.lock_graph:
        from vearch_tpu_torch.tools.lint import callgraph

        artifact = (callgraph.LAST.lock_graph_artifact()
                    if callgraph.LAST is not None
                    else {"nodes": [], "edges": [], "cycles": []})
        print(json.dumps(artifact, indent=2, sort_keys=True))
        return 0

    if args.changed_only is not None:
        changed = _changed_files(args.changed_only)
        if changed is None:
            print(f"vearch-lint: cannot diff against "
                  f"{args.changed_only!r} (not a git checkout?)",
                  file=sys.stderr)
            return 2

        def _keep(f) -> bool:
            # unused-allowlist bookkeeping is whole-tree state: in a
            # changed-only run the tree wasn't fully relinted from the
            # ref's point of view, so it cannot be judged here
            if f.line == 0 and f.rule == "VL000":
                return False
            return os.path.abspath(f.path) in changed

        findings = [f for f in findings if _keep(f)]

    hard = [f for f in findings if not f.suppressed]
    soft = [f for f in findings if f.suppressed]

    if args.as_json:
        shown = hard + (soft if args.show_allowed else [])
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "tag": f.tag, "path": f.path,
                 "line": f.line, "message": f.message,
                 "suppressed": f.suppressed, "reason": f.reason}
                for f in shown
            ],
            "hard": len(hard),
            "allowed": len(soft),
        }, indent=2))
        return 1 if hard else 0

    for f in hard:
        print(f.render())
    if args.show_allowed:
        for f in soft:
            print(f.render())
    print(f"vearch-lint: {len(hard)} finding(s), "
          f"{len(soft)} allowed with reasons")
    return 1 if hard else 0


if __name__ == "__main__":
    sys.exit(main())
