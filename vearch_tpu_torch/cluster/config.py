"""TOML config loader (reference: config/config.toml parsed by
internal/config/config.go — one file for all roles with [global],
[masters], [router], [ps] sections + per-role Validate).

Example:

    [global]
    name = "vearch-tpu"
    data = "./vearch_data"
    auth = false
    root_password = "secret"

    [master]
    host = "127.0.0.1"
    port = 8817
    heartbeat_ttl = 8.0

    [router]
    port = 9001
    fanout_workers = 0        # 0 = auto-size with partition count
    cache_entries = 512       # merged-result cache; 0 disables
    cache_ttl_s = 10.0        # safety net for unseen writers
    hedge_quantile = 0.95     # adaptive hedge delay quantile; 0 disables
    hedge_budget_pct = 10.0   # hedges stay <= this % of scatter RPCs
    replica_read = false      # reads to the least-loaded live replica

    [ps]
    port = 8081
    max_concurrent_searches = 256
    search_cache_entries = 256  # partition result cache; 0 disables
    admission_queue_limit = 0   # shed (429) past this many waiters; 0 off
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Config:
    global_: dict[str, Any] = field(default_factory=dict)
    master: dict[str, Any] = field(default_factory=dict)
    router: dict[str, Any] = field(default_factory=dict)
    ps: dict[str, Any] = field(default_factory=dict)
    # reference: [tracer] block (sampler type/param), startup.go:66-85
    tracer: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        cfg = cls(
            global_=raw.get("global", {}),
            master=raw.get("master", {}),
            router=raw.get("router", {}),
            ps=raw.get("ps", {}),
            tracer=raw.get("tracer", {}),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """Per-role sanity checks (reference: per-role Validate,
        cmd/vearch/startup.go:168)."""
        for section, d in (("master", self.master), ("router", self.router),
                           ("ps", self.ps)):
            port = d.get("port")
            if port is not None and not (0 <= int(port) < 65536):
                raise ValueError(f"[{section}] port {port} out of range")
        ttl = self.master.get("heartbeat_ttl")
        if ttl is not None and float(ttl) <= 0:
            raise ValueError("[master] heartbeat_ttl must be positive")
        rate = self.tracer.get("sample_rate")
        if rate is not None and not (0.0 <= float(rate) <= 1.0):
            raise ValueError("[tracer] sample_rate must be in [0, 1]")
        for key in ("fanout_workers", "cache_entries"):
            v = self.router.get(key)
            if v is not None and int(v) < 0:
                raise ValueError(f"[router] {key} must be >= 0")
        ttl = self.router.get("cache_ttl_s")
        if ttl is not None and float(ttl) < 0:
            raise ValueError("[router] cache_ttl_s must be >= 0")
        sce = self.ps.get("search_cache_entries")
        if sce is not None and int(sce) < 0:
            raise ValueError("[ps] search_cache_entries must be >= 0")
        hq = self.router.get("hedge_quantile")
        if hq is not None and not (0.0 <= float(hq) < 1.0):
            raise ValueError("[router] hedge_quantile must be in [0, 1) "
                             "(0 disables hedging)")
        hb = self.router.get("hedge_budget_pct")
        if hb is not None and not (0.0 <= float(hb) <= 100.0):
            raise ValueError("[router] hedge_budget_pct must be in "
                             "[0, 100]")
        aql = self.ps.get("admission_queue_limit")
        if aql is not None and int(aql) < 0:
            raise ValueError("[ps] admission_queue_limit must be >= 0 "
                             "(0 disables shedding)")

    @property
    def data_dir(self) -> str:
        return self.global_.get("data", "./vearch_data")

    @property
    def log_level(self) -> str:
        """Reference: [global] level (config.go GetLogInfoWriteSwitch)."""
        return str(self.global_.get("log_level", "info"))

    @property
    def log_dir(self) -> str:
        return self.log_dir_for(self.data_dir)

    def log_dir_for(self, data_dir: str) -> str:
        """Log directory given the EFFECTIVE data dir (a --data-dir CLI
        override may differ from the TOML value): explicit [global] log
        wins, otherwise logs live under the data dir."""
        import os

        explicit = self.global_.get("log")
        return str(explicit) if explicit else os.path.join(data_dir, "logs")

    @property
    def auth(self) -> bool:
        return bool(self.global_.get("auth", False))

    @property
    def root_password(self) -> str:
        return str(self.global_.get("root_password", "secret"))
