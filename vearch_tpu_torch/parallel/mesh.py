"""Device meshes for one partition spanning several devices, the port of
vearch_tpu/parallel/mesh.py.

The reference lays a JAX `Mesh` with axes ("data", "query") over
`jax.devices()`: rows shard over "data", the query batch over "query".
Here a mesh is the same [data, query] grid of torch devices, and a
sharded array is a `MeshArray`: one tensor a shard, placed on its
device, plus a copy on any other device of the grid that reads it (a
row shard is replicated over "query", a query shard over "data", as the
reference's PartitionSpecs say).

- The devices of a mesh are the visible devices of one type: the cards
  for "cuda", the host for "cpu". `VIRTUAL_DEVICE_COUNT` (None: off)
  makes a mesh see that many devices, the physical ones repeated in
  turn, so a 4x1 mesh runs four shards on one card and an 8x1 mesh eight
  shards on the CPU (the counterpart of the reference tests'
  `--xla_force_host_platform_device_count=8`). It is a process-wide
  setting for tests and the card's smoke run, not a request parameter.
- `physical_device_count` is what `mesh_serving: "auto"` reads: virtual
  shards never turn a search onto the mesh by themselves.
- Meshes are cached per (devices, data axis, query axis): the sharded
  row caches key on mesh identity, as the reference's program caches do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import host_sqnorms, to_device_mask

#: devices a mesh sees (None: the physical devices of its type)
VIRTUAL_DEVICE_COUNT: int | None = None


def set_virtual_device_count(n: int | None) -> None:
    """Let meshes see `n` devices (the physical ones repeated), or the
    physical devices again with None."""
    global VIRTUAL_DEVICE_COUNT
    VIRTUAL_DEVICE_COUNT = None if n is None else int(n)


def _physical_devices(device_type: str) -> list[torch.device]:
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def physical_device_count(device_type: str) -> int:
    return len(_physical_devices(device_type))


def visible_devices(device_type: str) -> list[torch.device]:
    """The devices a mesh of this type spans: the physical ones, or
    VIRTUAL_DEVICE_COUNT of them taken in turn."""
    phys = _physical_devices(device_type)
    if not phys:
        raise RuntimeError(f"no {device_type} device is visible")
    if VIRTUAL_DEVICE_COUNT is None:
        return phys
    return [phys[i % len(phys)] for i in range(VIRTUAL_DEVICE_COUNT)]


def _device_type(device_type) -> str:
    """A mesh's device type: the caller's, else the port's default
    device (the card; raises without one)."""
    if device_type is None:
        from vearch_tpu_torch.device import resolve_device

        return resolve_device(None).type
    return torch.device(device_type).type


class Mesh:
    """A [data, query] grid of torch devices; `devices[i][j]` holds row
    shard i and query shard j."""

    def __init__(self, devices: tuple, data_axis: int, query_axis: int):
        self.devices = [[devices[i * query_axis + j]
                         for j in range(query_axis)]
                        for i in range(data_axis)]
        self.shape = {"data": data_axis, "query": query_axis}
        self.size = data_axis * query_axis
        self.device_type = devices[0].type

    @property
    def first(self) -> torch.device:
        """Where the merges across shards run."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['data']}x{self.shape['query']}, "
                f"{self.device_type})")


def default_mesh(device_type=None) -> Mesh:
    """All visible devices of the type, rows on "data"."""
    return make_mesh(query_axis=1, device_type=device_type)


@functools.lru_cache(maxsize=32)
def _mesh_cached(devices: tuple, data_axis: int, query_axis: int) -> Mesh:
    return Mesh(devices, data_axis, query_axis)


def make_mesh(
    n_devices: int | None = None,
    data_axis: int | None = None,
    query_axis: int = 1,
    device_type=None,
) -> Mesh:
    """2D mesh ("data", "query") over the first n visible devices; by
    default every device is on "data" (row sharding)."""
    devs = visible_devices(_device_type(device_type))
    n = min(n_devices or len(devs), len(devs))
    if data_axis is None:
        data_axis = n // query_axis
    assert data_axis * query_axis == n, (
        f"mesh {data_axis}x{query_axis} != {n} devices"
    )
    return _mesh_cached(tuple(devs[:n]), data_axis, query_axis)


def mesh_from_shape(shape, device_type=None) -> Mesh:
    """Resolve a `mesh_shape` knob ("4x2", (data, query), a device count,
    or None/""/"auto"/"default" for the default mesh) to a cached mesh."""
    if shape in (None, "", "auto", "default"):
        return default_mesh(device_type)
    if isinstance(shape, str):
        parts = shape.lower().split("x")
        if len(parts) == 1:
            return make_mesh(int(parts[0]), device_type=device_type)
        da, qa = (int(p) for p in parts[:2])
        return make_mesh(da * qa, data_axis=da, query_axis=qa,
                         device_type=device_type)
    if isinstance(shape, (list, tuple)):
        da, qa = int(shape[0]), int(shape[1])
        return make_mesh(da * qa, data_axis=da, query_axis=qa,
                         device_type=device_type)
    return make_mesh(int(shape), device_type=device_type)


def mesh_tag(mesh: Mesh) -> str:
    return f"{mesh.shape['data']}x{mesh.shape['query']}"


class MeshArray:
    """An array laid over a mesh: `parts[s]` is shard s (row shards over
    "data", query shards over "query", or one replicated part), on the
    grid's first device of that shard. `local(i, j)` is what device
    (i, j) reads, copied there once when it is another device."""

    def __init__(self, mesh: Mesh, parts: list, axis: str | None,
                 shape: tuple):
        self.mesh = mesh
        self.parts = parts
        self.axis = axis
        self.shape = shape
        self.dtype = parts[0].dtype
        self._copies: dict = {}

    def _key(self, i: int, j: int) -> int:
        return {"data": i, "query": j}.get(self.axis, 0)

    def local(self, i: int, j: int = 0) -> torch.Tensor:
        key = self._key(i, j)
        part = self.parts[key]
        dev = self.mesh.devices[i][j]
        if part.device == dev:
            return part
        copy = self._copies.get((key, dev))
        if copy is None:
            copy = self._copies[(key, dev)] = part.to(dev)
        return copy

    def write_rows(self, s: int, lo: int, rows: torch.Tensor) -> None:
        """Write `rows` into shard s at local row `lo`, and into every
        copy of it, in place."""
        targets = [self.parts[s]] + [c for (key, _d), c in
                                     self._copies.items() if key == s]
        for t in targets:
            t[lo:lo + rows.shape[0]] = rows.to(t.device)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _nbytes(x) -> int:
    return int(x.numel() * x.element_size()) if isinstance(
        x, torch.Tensor) else int(np.asarray(x).nbytes)


def shard_rows(mesh: Mesh, x, pad_value=0) -> tuple[MeshArray, int]:
    """Row-shard a [N, ...] array (host numpy or a tensor) over "data",
    padding N to a multiple of the axis size. Returns (array, orig_n)."""
    n_shards = mesh.shape["data"]
    t = _as_tensor(x)
    n = t.shape[0]
    rem = (-n) % n_shards
    if rem:
        t = torch.cat([t, torch.full((rem,) + tuple(t.shape[1:]), pad_value,
                                     dtype=t.dtype, device=t.device)])
    if t.device.type == "cpu":
        perf_model.note_h2d_bytes(_nbytes(t))
    local = t.shape[0] // n_shards
    parts = [t[i * local:(i + 1) * local].to(mesh.devices[i][0], copy=True)
             for i in range(n_shards)]
    return MeshArray(mesh, parts, "data", tuple(t.shape)), n


def shard_queries(mesh: Mesh, q) -> tuple[MeshArray, int]:
    """Shard a [B, d] query batch over "query" (replicated over "data"),
    padding B with zero rows. Returns (array, orig_b)."""
    n_shards = mesh.shape["query"]
    t = _as_tensor(q)
    b = t.shape[0]
    rem = (-b) % n_shards
    if rem:
        t = torch.cat([t, torch.zeros((rem, t.shape[1]), dtype=t.dtype,
                                      device=t.device)])
    perf_model.note_h2d_bytes(_nbytes(t))
    local = t.shape[0] // n_shards
    parts = [t[j * local:(j + 1) * local].to(mesh.devices[0][j])
             for j in range(n_shards)]
    return MeshArray(mesh, parts, "query", tuple(t.shape)), b


def replicate(mesh: Mesh, x) -> MeshArray:
    t = _as_tensor(x)
    perf_model.note_h2d_bytes(_nbytes(t))
    return MeshArray(mesh, [t.to(mesh.first)], None, tuple(t.shape))


class ShardedRowCache:
    """Grow-only cache of host row arrays placed row-sharded on a mesh.

    `get` re-places when the capacity changed and tail-appends when rows
    merely grew within it and the caller gives `append_host_fn`: one
    copy of only the new rows to each shard they touch, written in place
    (rows past a search's row count are masked by its validity mask, so
    an in-flight search never reads them). `lower_rows` must be called
    when rows below the high-water mark were overwritten (re-absorb,
    engine load); `invalidate` drops everything.

    `sqnorm_of=i` keeps a derived [cap] f32 squared-norm column of
    arrays[i] (`self.sqnorm`) in lockstep, computed on the host from the
    rows as placed (`ops/distance.host_sqnorms`), so it is the column
    the single-device raw store keeps.

    `stats` counts rebuilds / appends / host-to-device bytes. The cache
    keys on mesh identity: a new `mesh_shape` re-places on the next get.
    """

    def __init__(self, align: int, sqnorm_of: int | None = None):
        self.align = align
        self.sqnorm_of = sqnorm_of
        self._key = None
        self._rows = 0
        self.arrays: tuple | None = None
        self.sqnorm: MeshArray | None = None
        self.stats = {"rebuilds": 0, "appends": 0, "h2d_bytes": 0}

    def capacity(self, mesh: Mesh, n: int) -> int:
        """Sharded capacity for n rows: align * n_shards units, grown
        geometrically past the placed capacity so absorbs amortize to
        tail-appends."""
        unit = self.align * mesh.shape["data"]
        need = -(-max(n, 1) // unit) * unit
        if self._key is not None and self._key[0] == id(mesh):
            cur = self._key[1]
            if cur >= need:
                return cur
            return max(need, 2 * cur)
        return need

    @staticmethod
    def _sqnorms(rows) -> np.ndarray:
        t = _as_tensor(rows)
        return host_sqnorms(t.float().numpy())

    def get(self, mesh: Mesh, n: int, build_host_fn, append_host_fn=None):
        """build_host_fn(cap) -> tuple of host arrays with cap rows;
        append_host_fn(lo, hi) -> tuple of host arrays with hi-lo rows
        (rows [lo, hi) of each cached array). Returns (arrays, rebuilt)."""
        cap = self.capacity(mesh, n)
        key = (id(mesh), cap)
        rebuilt = False
        if self._key == key and self.arrays is not None and self._rows < n \
                and append_host_fn is not None:
            self._append(mesh, n, cap, append_host_fn)
        elif self._key != key or self._rows < n or self.arrays is None:
            hosts = build_host_fn(cap)
            self.arrays = tuple(shard_rows(mesh, h)[0] for h in hosts)
            if self.sqnorm_of is not None:
                self.sqnorm = shard_rows(
                    mesh, self._sqnorms(hosts[self.sqnorm_of]))[0]
            self._key = key
            self._rows = n
            rebuilt = True
            self.stats["rebuilds"] += 1
            self.stats["h2d_bytes"] += sum(_nbytes(h) for h in hosts)
        return self.arrays, rebuilt

    def _append(self, mesh: Mesh, n: int, cap: int, append_host_fn) -> None:
        """Write rows [rows_hw, n) in place: the window is align-rounded,
        sliced per shard and copied only to the shards it touches."""
        n_shards = mesh.shape["data"]
        local_n = cap // n_shards
        lo = (self._rows // self.align) * self.align
        hi = min(-(-n // self.align) * self.align, cap)
        tails = [_as_tensor(t) for t in append_host_fn(lo, hi)]
        columns = list(zip(self.arrays, tails))
        if self.sqnorm_of is not None:
            columns.append((self.sqnorm, torch.from_numpy(
                self._sqnorms(tails[self.sqnorm_of]))))
        for arr, tail in columns:
            for s in range(n_shards):
                a = max(lo, s * local_n)
                b = min(hi, (s + 1) * local_n)
                if a >= b:
                    continue
                win = tail[a - lo:b - lo]
                moved = _nbytes(win)
                self.stats["h2d_bytes"] += moved
                perf_model.note_h2d_bytes(moved)
                arr.write_rows(s, a - s * local_n, win)
        self._rows = n
        self.stats["appends"] += 1

    def lower_rows(self, start: int) -> None:
        self._rows = min(self._rows, start)

    def invalidate(self) -> None:
        self._key = None
        self._rows = 0
        self.arrays = None
        self.sqnorm = None


class ShardedMaskCache:
    """A validity mask row-sharded over a mesh, cached per source mask
    identity (the engine keeps one alive mask a data version; the strong
    reference keeps the identity check sound), mesh and row counts."""

    def __init__(self):
        self._src = None
        self._key = None
        self._sharded: MeshArray | None = None

    def get(self, mesh: Mesh, valid_mask, n: int, cap: int) -> MeshArray:
        """[cap] bool sharded like the rows: valid_mask's first n
        entries (all n rows when it is None), False past them."""
        key = (id(mesh), n, cap)
        if (valid_mask is not None and self._src is valid_mask
                and self._key == key):
            return self._sharded
        if isinstance(valid_mask, torch.Tensor):
            host = to_device_mask(valid_mask, n, cap, valid_mask.device)
        else:
            host = np.zeros(cap, dtype=bool)
            if valid_mask is None:
                host[:n] = True
            else:
                vm = np.asarray(valid_mask)[:n]
                host[: vm.shape[0]] = vm
        self._sharded, _ = shard_rows(mesh, host)
        self._src, self._key = valid_mask, key
        return self._sharded
