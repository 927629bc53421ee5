"""Performance model of the serving path, the port of
vearch_tpu/ops/perf_model.py: arithmetic over shapes that tests hold
against the live ledgers, and the runtime layer (obs/) holds against the
card.

Layers:

1. `PerfLedger`, a drop-in for the plain-list dispatch ledger
   (ops/ivf.py set_dispatch_ledger), and `DOCUMENTED_DISPATCHES`, the
   search programs each serving path runs (the reference's tag names;
   `path_for_dispatches` looks a tag list up).
2. Padded shape buckets: every search is padded to a declared row tier
   and its candidate depth raised to a declared fetch-k tier, so results
   and the set of shapes the kernels see are the reference's.
3. Program tracking, the GPU meaning of the reference's jit-cache audit.
   There is no jit here; a "compiled program" is either the build or
   load of a native library (`ops/_cuda_build.py`, program
   `build.<source>`) or the first call of a registered op or kernel
   wrapper (`register_op`) at a new shape signature, which on the card
   is where a kernel first launches at that shape and the caching
   allocator first sizes its buffers. `compiled_program_counts()` counts
   signatures per program; the installed compile observer (the flight
   recorder) hears each new one with the wall time of its call.
4. Bytes models: peak intermediate bytes and scan traffic per search,
   resident device bytes per index structure (the `device_footprint_*`
   methods of the indexes feed on these, and obs/sampler.py holds their
   sum against `torch.cuda.memory_stats`), and the host -> device ledger.
5. Rooflines against the card's published peaks (`PEAK_OPS`), never a
   TPU's.
"""

from __future__ import annotations

import enum
import functools
import threading
import time
import weakref
from typing import Any, Callable

# must match ops/blockmax_scan.py BLOCK, STAGE2_CHUNK and STAGE2_SORT_ELEMS
BLOCK = 512
BLOCKMAX_STAGE2_CHUNK = 32
BLOCKMAX_SORT_ELEMS = 1 << 25
# device bytes a sorted element takes at the peak of torch's stable
# segmented sort (values and int64 positions out, its keys, positions and
# segment ids, double-buffered), measured on an H100 at stage 2's sort of
# [248, 135,168] f32 (32-57 across the sort shapes tried)
SORT_PEAK_BYTES = 44

F32 = 4
I32 = 4
I64 = 8


# -- 1. dispatch ledger ------------------------------------------------------


class PerfLedger:
    """Dispatch ledger with per-search aggregation. Call sites only
    `append(tag)`, so a plain list and this class are interchangeable."""

    def __init__(self) -> None:
        self.tags: list[str] = []
        self._marks: list[int] = []

    def append(self, tag: str) -> None:
        self.tags.append(tag)

    def __iter__(self):
        return iter(self.tags)

    def __len__(self) -> int:
        return len(self.tags)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PerfLedger):
            return self.tags == other.tags
        return self.tags == other

    def mark_search(self) -> None:
        """Tags appended after this call belong to the next search."""
        self._marks.append(len(self.tags))

    def per_search(self) -> list[list[str]]:
        """Tags grouped by the mark_search() boundaries."""
        bounds = sorted({0, *self._marks, len(self.tags)})
        return [self.tags[a:b] for a, b in zip(bounds, bounds[1:])]

    def dispatch_count(self) -> int:
        return len(self.tags)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for t in self.tags:
            out[t] = out.get(t, 0) + 1
        return out


#: search programs per engine-level search, by serving path (the
#: reference's table; on the card one tag is one index-level search
#: program: many PyTorch launches plus the hand kernels). The mesh rows
#: stay for the reference's lookups; the port serves one device.
DOCUMENTED_DISPATCHES: dict[str, list[str]] = {
    "ivfpq_full_fused": ["fused_scan_rerank"],
    "ivfpq_full_unfused": ["scan", "rerank"],
    "ivfpq_full_pallas": ["pallas_blockmax_scan", "rerank"],
    "ivfpq_probe": ["probe_scan", "rerank"],
    "ivfflat": ["ivfflat_scan"],
    "flat": ["flat_scan"],
    "cache_hit": [],
    "ivfpq_mesh_fused": ["sharded_fused_scan_rerank"],
    "ivfpq_mesh_unfused": ["sharded_scan", "sharded_rerank"],
    "ivfpq_mesh_scan": ["sharded_scan"],
    "ivfpq_mesh_probe": ["sharded_probe_scan_rerank"],
    "flat_sharded": ["sharded_flat_scan"],
    "ivfrabitq_three_stage": ["binary_refine_rerank"],
    "ivfrabitq_three_stage_disk": ["binary_refine_scan", "rerank"],
    "ivfrabitq_mesh_three_stage": ["sharded_binary_refine_rerank"],
}


def path_for_dispatches(tags: list[str]) -> str | None:
    """The documented serving path that ran exactly this tag sequence,
    or None (a multi-field search concatenates several paths)."""
    seq = list(tags)
    for path, doc in DOCUMENTED_DISPATCHES.items():
        if seq == doc:
            return path
    return None


# -- 2. padded shape buckets -------------------------------------------------

#: declared row tiers for batched serving dispatches
ROW_BUCKETS: tuple[int, ...] = (8, 64, 256, 1024)
#: declared fetch-k tiers (candidate depth handed to the index)
FETCH_K_TIERS: tuple[int, ...] = (16, 64, 256, 1024)
#: declared recall-estimator depths (obs/quality.py shadow sampling)
RECALL_K_TIERS: tuple[int, ...] = (1, 10, 100)


def bucket_rows(b: int) -> int:
    """Smallest declared row tier holding `b` rows; above the top tier
    returns `b` unchanged."""
    for t in ROW_BUCKETS:
        if b <= t:
            return t
    return int(b)


def bucket_fetch_k(k: int) -> int:
    """Smallest declared fetch-k tier covering depth `k`; above the top
    tier returns `k` unchanged."""
    for t in FETCH_K_TIERS:
        if k <= t:
            return t
    return int(k)


def bucket_program_bound(row_tiers: int | None = None,
                         k_tiers: int | None = None) -> int:
    """Upper bound on shape signatures per scan path once both axes are
    quantized: the full declared grid."""
    r = len(ROW_BUCKETS) if row_tiers is None else int(row_tiers)
    k = len(FETCH_K_TIERS) if k_tiers is None else int(k_tiers)
    return r * k


def bucket_dispatch_bound(n_requests: int, bucket_capacity: int) -> int:
    """Most dispatches a continuous-batching scheduler may issue for
    `n_requests` single-row requests sharing one bucket key."""
    return -(-int(n_requests) // max(int(bucket_capacity), 1))


def padding_waste_bytes(real_rows: int, padded_rows: int, d: int,
                        itemsize: int = F32) -> int:
    """Query bytes a padded dispatch moves for nobody: the pad rows of
    the [padded_rows, d] query block."""
    return max(int(padded_rows) - int(real_rows), 0) * int(d) * int(itemsize)


def refine_depths(k: int, n: int) -> tuple[int, int]:
    """Auto candidate depths (r0, r1) of IVFRABITQ's three-stage chain:
    r1 = max(10k, 128), the int8 rerank default, and r0 = max(3.2 r1,
    512) for the selection-grade 1-bit stage 0; both clamp to the row
    count. Request and index params `r0`/`r1` override them."""
    n = max(int(n), 1)
    r1 = min(max(10 * int(k), 128), n)
    r0 = min(max(32 * r1 // 10, 512), n)
    return max(r0, r1), r1


# -- 3. program tracking ------------------------------------------------------

_programs_lock = threading.Lock()
_PROGRAMS: dict[str, set[str]] = {}  # program -> shape signatures seen

# Optional compile observer (obs/flight_recorder installs one): called as
# observer(program, shape_signature, elapsed_ms) for each new program
# signature, from the thread whose call made it.
_compile_observer: Any = None


def set_compile_observer(fn: Any) -> None:
    """Install (or clear, with None) the process-wide compile observer."""
    global _compile_observer
    _compile_observer = fn


def _sig_of(v: Any) -> str:
    """One argument's part of a call signature: dtype and shape for a
    tensor, the value for a plain scalar (a different k is a different
    program), the type name otherwise."""
    shp = getattr(v, "shape", None)
    if shp is not None:
        return f"{v.dtype}{tuple(shp)}"
    if isinstance(v, (bool, int, float, str)) or v is None:
        return repr(v)
    if isinstance(v, enum.Enum):
        return str(v)
    return type(v).__name__


def shape_signature(args: tuple, kwargs: dict) -> str:
    parts = [_sig_of(a) for a in args]
    parts += [f"{k}={_sig_of(kwargs[k])}" for k in sorted(kwargs)]
    return "|".join(parts)


def note_program(name: str, signature: str, elapsed_ms: float) -> bool:
    """Record one program signature; a new one is a compile event for
    the observer. Returns whether it was new."""
    with _programs_lock:
        seen = _PROGRAMS.setdefault(name, set())
        if signature in seen:
            return False
        seen.add(signature)
    obs = _compile_observer
    if obs is not None:
        obs(name, signature, elapsed_ms)
    return True


def register_op(name: str) -> Callable[[Callable], Callable]:
    """Decorator: track the function's calls by shape signature (program
    `name`); a first call at a new signature is a compile event."""
    with _programs_lock:
        _PROGRAMS.setdefault(name, set())

    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def observed(*args, **kwargs):
            sig = shape_signature(args, kwargs)
            with _programs_lock:
                known = sig in _PROGRAMS[name]
            if known:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            note_program(name, sig, (time.perf_counter() - t0) * 1e3)
            return out

        return observed

    return decorate


def compiled_program_counts() -> dict[str, int]:
    """Shape signatures seen per program (builds count one each)."""
    with _programs_lock:
        return {name: len(sigs) for name, sigs in _PROGRAMS.items()}


def total_compiled_programs() -> int:
    return sum(compiled_program_counts().values())


# -- host -> device bytes ledger ----------------------------------------------
#
# The raw store's and the mirrors' uploads and the disk tier's slab
# uploads note their bytes here. With a warm cache the disk tier moves
# ZERO bytes a search; a miss pays one slab upload, four arrays of fixed
# shape [cap, ...]:
#
#     int8 rows   cap * d   bytes
#     scale f32   cap * 4
#     vsq   f32   cap * 4
#     docids i32  cap * 4
#
# so slab_bytes(cap, d) = cap * (d + 12), and a resolve with `m` misses
# moves tier_h2d_bytes(m, cap, d) = m * slab_bytes. The per-slot live-row
# count the port keeps beside the pools (`pool_lens`, 4 B a slot) is
# counted on the device and moves no bytes.

_h2d_lock = threading.Lock()
_h2d_bytes_total = 0

# Optional H2D observer (obs/accounting installs one): called with the
# byte count from the same note_h2d_bytes call that feeds the total.
_h2d_observer: Any = None


def set_h2d_observer(fn: Any) -> None:
    """Install (or clear, with None) the process-wide H2D byte observer."""
    global _h2d_observer
    _h2d_observer = fn


def note_h2d_bytes(n: int) -> None:
    """Record `n` bytes copied host -> device."""
    global _h2d_bytes_total
    with _h2d_lock:
        _h2d_bytes_total += int(n)
    obs = _h2d_observer
    if obs is not None:
        obs(int(n))


def h2d_bytes_total() -> int:
    with _h2d_lock:
        return _h2d_bytes_total


# cuBLAS workspaces, the device bytes of PyTorch's runtime that no index
# holds. PyTorch gives each thread that runs a cuBLAS call a handle from a
# per-card pool, and each (handle, stream) a workspace from the caching
# allocator, kept until torch._C._cuda_clearCublasWorkspaces(); a handle
# goes back to the pool when its thread ends, and the next new thread
# takes it with its workspace. So a process holds one workspace for each
# thread that ran cuBLAS while the others did: the peak number of such
# threads alive at once. The engine notes every thread it runs device
# work on (`note_blas_thread`: searches, builds, the refresh loop's
# absorbs), and that thread runs a 1x1 product at once, so it holds its
# workspace from then on whatever it runs next. The partition server's
# sampler adds `blas_workspace_bytes()` to its engines' models
# (obs/sampler.py). The census of one server on the card (chip_smoke.py
# census_main, PERF.md) found exactly these blocks past the models:
# 33,554,432 bytes each, on torch 2.11 and an H100.

_blas_lock = threading.Lock()
_blas_tls = threading.local()
_blas_threads: dict[int, weakref.WeakSet] = {}
_blas_peak: dict[int, int] = {}


def cublas_workspace_size(device: Any) -> int:
    """Bytes of one cuBLAS workspace on `device`, as PyTorch sizes it:
    the `:SIZE_KiB:COUNT` pairs of CUBLAS_WORKSPACE_CONFIG summed when it
    is set, else 4096 KiB x 8 on sm_90 and 4096 KiB x 2 + 16 KiB x 8 on
    other cards."""
    import os

    import torch

    cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if cfg:
        vals = [int(v) for v in cfg.split(":") if v]
        return sum(vals[i] * vals[i + 1] * 1024
                   for i in range(0, len(vals) - 1, 2))
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) == (9, 0):
        return 4096 * 1024 * 8
    return 4096 * 1024 * 2 + 16 * 1024 * 8


def _prime_blas(device: Any) -> None:
    """A 1x1 product on `device`: the calling thread's cuBLAS handle and
    workspace exist from here on."""
    import torch

    one = torch.ones((1, 1), device=device)
    torch.mm(one, one)


def note_blas_thread(device: Any) -> None:
    """Count the calling thread among those holding a cuBLAS workspace on
    `device` (a CUDA device; a no-op for any other, and for a thread
    already counted)."""
    if getattr(device, "type", None) != "cuda":
        return
    index = device.index if device.index is not None else 0
    noted = getattr(_blas_tls, "devices", None)
    if noted is None:
        noted = _blas_tls.devices = set()
    if index in noted:
        return
    _prime_blas(device)
    noted.add(index)
    me = threading.current_thread()
    with _blas_lock:
        threads = _blas_threads.setdefault(index, weakref.WeakSet())
        threads.add(me)
        live = sum(1 for t in threads if t.is_alive())
        _blas_peak[index] = max(_blas_peak.get(index, 0), live)


def blas_workspace_bytes(device: Any) -> int:
    """The cuBLAS workspaces this process holds on `device`: the peak
    number of live noted threads, times one workspace."""
    if getattr(device, "type", None) != "cuda":
        return 0
    index = device.index if device.index is not None else 0
    with _blas_lock:
        peak = _blas_peak.get(index, 0)
    return peak * cublas_workspace_size(device) if peak else 0


def slab_bytes(cap: int, d: int) -> int:
    """H2D bytes one bucket-slab upload moves (int8 rows + scale + vsq
    + docids at the cache's fixed row capacity `cap`)."""
    return int(cap) * (int(d) + 12)


def tier_h2d_bytes(misses: int, cap: int, d: int) -> int:
    """Modelled bytes for a resolve with `misses` slab misses: zero on a
    full hit, one slab_bytes per missed bucket otherwise."""
    return int(misses) * slab_bytes(cap, d)


# -- 4. bytes models ------------------------------------------------------------


def blockmax_selected_blocks(r: int, n_pad: int) -> int:
    """Blocks stage 2 re-scores: the 2x+8 over-selection of
    ops/ivf.py _select_topk and ops/blockmax_scan.py."""
    nblk = max(n_pad // BLOCK, 1)
    nb = max(32, min(r, n_pad) // 4)
    return min(2 * nb + 8, nblk)


def scan_peak_bytes(b: int, n_pad: int, d: int, r: int, path: str) -> int:
    """Peak intermediate device bytes one search materialises, by scan
    path (resident at once, not total traffic).

    - "xla_full": the [B, N] f32 score matrix (the int4 scan, the binary
      stage 0 and the "exact" selection build it; the reference's
      default XLA scan too).
    - "pallas_blockmax": the port's two kernels. Stage 1 writes [B, N/512]
      f32 maxima; stage 2 (ops/blockmax_scan.blockmax_stage2) holds the
      selection [B, nb_sel] int64, its slot map [N/512, B] int32 and
      tile map (at most [ceil(B/8), N/512] bytes: the narrowest query
      tile is 8 wide), the kernel's [B, S] f32 scores (S = nb_sel *
      512), the [B, rr] top-r (f32 scores, int64 positions) and the sort
      of one chunk of BLOCKMAX_SORT_ELEMS scores (SORT_PEAK_BYTES an
      element). No gathered or widened copy of the rows exists; the
      reference's stage 2 holds one 32-query chunk of gathered rows (d +
      4 + 4 bytes a row) instead.
    """
    if path == "xla_full":
        return b * n_pad * F32
    if path == "pallas_blockmax":
        nblk = max(n_pad // BLOCK, 1)
        nb_sel = blockmax_selected_blocks(r, n_pad)
        s = nb_sel * BLOCK
        rr = min(r, n_pad, s)
        rows = min(b, max(1, BLOCKMAX_SORT_ELEMS // s))
        return (b * nblk * F32 + b * nb_sel * I64 + nblk * b * I32
                + -(-b // 8) * nblk + b * s * F32 + b * rr * (F32 + I64)
                + rows * s * SORT_PEAK_BYTES)
    raise ValueError(f"unknown scan path {path!r}")


def scan_traffic_bytes(b: int, n_pad: int, d: int, path: str) -> int:
    """Device bytes the stage-1 pass reads over the database: the int8
    mirror rows, once (the bandwidth term of the roofline)."""
    del b, path
    return n_pad * d


def mirror_footprint_bytes(n_cap: int, d: int, storage: str = "int8") -> int:
    """Resident bytes of the docid-ordered compressed mirror: rows (d
    bytes, or d/2 for int4) + per-row scale + per-row |v|^2
    (index/int8_mirror.py)."""
    width = d if storage == "int8" else (d + 1) // 2
    return n_cap * width + 2 * n_cap * F32


def binary_plane_bytes(n_cap: int, d: int) -> int:
    """Row payload of the packed bit-plane mirror: ceil(d/8) bytes a row
    (8 * this <= the int8 mirror's total for every d)."""
    return int(n_cap) * (-(-int(d) // 8))


def binary_footprint_bytes(n_cap: int, d: int) -> int:
    """Resident bytes of the bit-plane mirror: planes + per-row scale +
    per-row |approx|^2, what Int8Mirror(storage="bits").device_bytes()
    reports."""
    return binary_plane_bytes(n_cap, d) + 2 * int(n_cap) * F32


def binary_scan_traffic_bytes(n_pad: int, d: int) -> int:
    """Bytes stage 0 reads a query batch: each packed plane once."""
    return int(n_pad) * (-(-int(d) // 8))


def raw_store_footprint_bytes(capacity: int, d: int, itemsize: int) -> int:
    """Raw device buffer + |v|^2 column (engine/raw_vector.py)."""
    return capacity * d * itemsize + capacity * F32


def per_device_bytes(sharded_bytes: int, replicated_bytes: int,
                     n_shards: int) -> int:
    """Resident bytes on each device of a placement: row-sharded state
    divides (ceil), replicated state rides whole. One device: the sum."""
    return replicated_bytes + -(-sharded_bytes // max(n_shards, 1))


def ivf_bucket_footprint_bytes(nlist: int, cap: int, d: int) -> int:
    """Probe-regime IVFPQ device state (index/ivf.py _publish_buckets):
    [nlist, cap, d] int8 residuals + per-cell scale + [nlist, cap] vsq
    and ids, as in the reference, plus the port's per-cell member counts
    (`_bucket_lens`, nlist int32) that the probe kernel reads."""
    return nlist * cap * d + nlist * F32 + 2 * nlist * cap * F32 + nlist * I32


# -- 5. rooflines -------------------------------------------------------------

#: dense peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, without
#: sparsity, at the 700 W limit): operations/s by operand type, and the
#: HBM3 bandwidth. No TPU figure: the port runs on the card.
PEAK_OPS: dict[str, dict[str, float]] = {
    "NVIDIA H100": {"bf16": 989e12, "int8": 1979e12, "f32": 67e12},
}
PEAK_BYTES_PER_S: dict[str, float] = {"NVIDIA H100": 3.35e12}
DEFAULT_CHIP = "NVIDIA H100"
#: the scan kernel converts int8 rows to bf16 in registers and runs bf16
#: tensor-core products, so its roofline is the bf16 peak
SCAN_OPERAND = "bf16"


def roofline_qps(n: int, d: int, peak_ops: float, rerank_r: int = 0) -> float:
    """Compute-roofline QPS of the full scan: one [1, d] x [d, N] product
    a query (2 ops a MAC) plus the exact rerank's."""
    ops_per_query = 2.0 * n * d + 2.0 * rerank_r * d
    return peak_ops / max(ops_per_query, 1.0)


def effective_qps(cold_qps: float, hit_rate: float,
                  hit_cost_frac: float = 0.0) -> float:
    """Throughput under a result cache: a hit costs `hit_cost_frac` of a
    cold query, a miss a whole one."""
    hit_rate = min(max(hit_rate, 0.0), 1.0)
    denom = hit_rate * max(hit_cost_frac, 0.0) + (1.0 - hit_rate)
    return cold_qps / max(denom, 1e-12)


def peak_ops(device_name: str | None, operand: str = SCAN_OPERAND
             ) -> tuple[str, float]:
    """(label, ops/s) of `operand` for a card name (prefix match, so
    "NVIDIA H100 80GB HBM3" resolves); an unknown or absent name falls
    back to DEFAULT_CHIP, labelled as assumed."""
    if device_name:
        for k in sorted(PEAK_OPS, key=len, reverse=True):
            if device_name.lower().startswith(k.lower()):
                return f"{k} {operand}", PEAK_OPS[k][operand]
    return (f"{DEFAULT_CHIP} {operand} (assumed)",
            PEAK_OPS[DEFAULT_CHIP][operand])
