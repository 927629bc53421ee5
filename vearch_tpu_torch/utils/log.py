"""Leveled, rotating, per-role logging (reference: internal/pkg/log —
the Log interface with Trace/Debug/Info/Warn/Error/Fatal levels and
IsDebugEnabled guards, backed by a rotating file writer, configured from
the TOML `[global]` block and adjustable at runtime).

Built on stdlib `logging` (thread-safe, zero deps) with:
- a TRACE level below DEBUG (the reference's finest level);
- one process-wide root logger `vearch` — `init()` attaches a
  size-rotating file handler (`{log_dir}/{role}.log`) plus stderr;
  without `init()` a stderr-only handler at $VEARCH_LOG_LEVEL (default
  info) self-installs on first use, so library users get sane logs
  with no setup;
- `set_level()` for runtime changes (wired to the master's /config
  fan-out so operators can flip a cluster to debug live);
- module-level `trace/debug/info/warn/error` + `is_debug_enabled()`
  mirroring the reference's package-level API.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import threading

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_root = logging.getLogger("vearch")
_root.propagate = False
_lock = threading.Lock()
_initialized = False

_FMT = logging.Formatter(
    "%(asctime)s.%(msecs)03d %(levelname)s %(name)s: %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)


def parse_level(name: str) -> int:
    try:
        return _LEVELS[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {name!r} (one of {sorted(_LEVELS)})"
        ) from None


def _ensure_default() -> None:
    global _initialized
    if _initialized:
        return
    with _lock:
        if _initialized:
            return
        h = logging.StreamHandler()
        h.setFormatter(_FMT)
        _root.addHandler(h)
        _root.setLevel(
            parse_level(os.environ.get("VEARCH_LOG_LEVEL", "info"))
        )
        _initialized = True


def init(
    role: str,
    log_dir: str | None = None,
    level: str = "info",
    max_bytes: int = 64 * 1024 * 1024,
    backups: int = 5,
    stderr: bool = True,
) -> None:
    """Configure process logging for a server role. Replaces any prior
    handlers (idempotent across restarts-in-process, as tests do)."""
    global _initialized
    with _lock:
        for h in list(_root.handlers):
            _root.removeHandler(h)
            h.close()
        if stderr:
            h = logging.StreamHandler()
            h.setFormatter(_FMT)
            _root.addHandler(h)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{role}.log"),
                maxBytes=max_bytes, backupCount=backups,
            )
            fh.setFormatter(_FMT)
            _root.addHandler(fh)
        _root.setLevel(parse_level(level))
        _initialized = True


def set_level(level: str) -> None:
    """Runtime level change (reference: log-level runtime config)."""
    _ensure_default()
    _root.setLevel(parse_level(level))


def get(name: str) -> logging.Logger:
    """Component logger, e.g. get('ps.raft') -> 'vearch.ps.raft'."""
    _ensure_default()
    return _root.getChild(name)


def is_debug_enabled() -> bool:
    _ensure_default()
    return _root.isEnabledFor(logging.DEBUG)


def is_trace_enabled() -> bool:
    _ensure_default()
    return _root.isEnabledFor(TRACE)


def trace(msg: str, *args) -> None:
    _ensure_default()
    _root.log(TRACE, msg, *args)


def debug(msg: str, *args) -> None:
    _ensure_default()
    _root.debug(msg, *args)


def info(msg: str, *args) -> None:
    _ensure_default()
    _root.info(msg, *args)


def warn(msg: str, *args) -> None:
    _ensure_default()
    _root.warning(msg, *args)


def error(msg: str, *args) -> None:
    _ensure_default()
    _root.error(msg, *args)
