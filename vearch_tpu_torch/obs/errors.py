"""Internal-error counter of the port: observability code that must keep
running (the quality monitor's worker, `Engine.quality_info`) records a
failure here instead of raising, and logs it."""

from __future__ import annotations

import logging
import threading

_log = logging.getLogger("vearch_tpu_torch.internal")
_lock = threading.Lock()
_counts: dict[str, int] = {}


def internal_error(site: str, exc: BaseException) -> None:
    """Count and log a swallowed failure at `site`."""
    with _lock:
        _counts[site] = _counts.get(site, 0) + 1
    _log.warning("internal error at %s: %s: %s", site, type(exc).__name__,
                 exc)


def internal_error_counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)
