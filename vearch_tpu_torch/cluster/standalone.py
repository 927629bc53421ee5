"""Standalone cluster: master + router + N partition servers in-process.

The reference ships an all-in-one mode where one binary runs every role
(reference: cmd/vearch/startup.go:112-120 role tags, CI standalone env).
Used by tests and the quickstart; production runs the roles as separate
processes on separate hosts with the same classes.

The port's copy: `ps_kwargs` reach every PSServer, a `device` among them
too, so `StandaloneCluster(ps_kwargs={"device": "cpu"})` serves on the
CPU and the default serves on the card.
"""

from __future__ import annotations

import tempfile

from vearch_tpu_torch.cluster.master import MasterServer
from vearch_tpu_torch.cluster.ps import PSServer
from vearch_tpu_torch.cluster.router import RouterServer


class StandaloneCluster:
    def __init__(
        self,
        data_dir: str | None = None,
        n_ps: int = 1,
        ps_kwargs: dict | None = None,
        router_kwargs: dict | None = None,
    ):
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="vearch_tpu_")
        self.master = MasterServer()
        self.ps_nodes: list[PSServer] = []
        self.router: RouterServer | None = None
        self.n_ps = n_ps
        # extra PSServer ctor args, applied to every node — lets tests
        # tighten observability knobs (drift slack, sample interval)
        # without reaching into started servers
        self.ps_kwargs = dict(ps_kwargs or {})
        # extra RouterServer ctor args — tail-latency tests tune the
        # hedge delay clamps and flip replica_read the same way
        self.router_kwargs = dict(router_kwargs or {})

    def start(self) -> "StandaloneCluster":
        self.master.start()
        for i in range(self.n_ps):
            ps = PSServer(
                data_dir=f"{self.data_dir}/ps{i}",
                master_addr=self.master.addr,
                **self.ps_kwargs,
            )
            ps.start()
            self.ps_nodes.append(ps)
        self.router = RouterServer(master_addr=self.master.addr,
                                   **self.router_kwargs)
        self.router.start()
        return self

    def add_ps(self) -> PSServer:
        """Join one more partition server to the running cluster — the
        target for migration/drain tests and live scale-out. Returns
        the started PS (it registers with the master on its own)."""
        ps = PSServer(
            data_dir=f"{self.data_dir}/ps{len(self.ps_nodes)}",
            master_addr=self.master.addr,
            **self.ps_kwargs,
        )
        ps.start()
        self.ps_nodes.append(ps)
        return ps

    def stop(self) -> None:
        if self.router:
            self.router.stop()
        for ps in self.ps_nodes:
            ps.stop()
        self.master.stop()

    @property
    def router_addr(self) -> str:
        return self.router.addr

    @property
    def master_addr(self) -> str:
        return self.master.addr

    def __enter__(self) -> "StandaloneCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
