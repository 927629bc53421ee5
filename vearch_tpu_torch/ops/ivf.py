"""IVF search ops, the port of vearch_tpu/ops/ivf.py.

Probe scans (the bucket layout built by index/ivf.py on publish:
centroids [nlist, d], bucket_ids [nlist, cap] int32 with -1 padding, and
per cell either bucket_vecs [nlist, cap, d] or the int8 residuals):

- `_coarse_probes`: top-nprobe cells per query, a full-f32 q.c product
  (`coarse_dots`) and the L2 coarse score's top-nprobe (`select_probes`),
  which both arms use; the kernel arm also keeps q.c for its scores.
- `ivfpq_candidates` / `ivfflat_candidates`: the reference's XLA arm, a
  loop over probe ranks that scores one bucket per query and folds it
  into a running top-r (`_fold_topk`). A `probes=` table may carry -1 in
  padded slots: such a step scans cell 0 fully masked, since scanning a
  real cell twice would duplicate its docids. The probe kernel's arm is
  `ops/probe_dots.ivfpq_probe_search`.

The full scan reads the docid-ordered int8 mirror (per-row scaled
approximations of the PQ-decoded vectors), selects top-r candidates and
reranks them exactly against the raw store:

- `int8_scan_candidates` / `_select_topk`: top-r over the int8 scores.
  The block-max branch (topk_mode "blockmax", or "auto" when the mirror
  has at least 4x as many 512-row blocks as it selects) runs stage 1
  through `ops/blockmax_scan.int8_blockmax_stage1` — the Hopper kernel
  on a CUDA tensor — so the [B, N] score matrix is never built. The
  "exact" branch keeps the reference's plain top-k over a full score
  matrix (`torch.matmul`, as the reference left that product to XLA).
- `select_topk_scores`: the reference's form of that selection, over a
  materialised [B, N] score matrix; the binary stage 0
  (`ops/binary_scan.py`) selects through it.
- `int4_scan_candidates`: the int4 mirror's full scan (`unpack_int4`,
  then an f32 product of the bf16-rounded queries with the unpacked
  values, which is exact, and `select_topk_scores` over the [B, N]
  matrix): plain PyTorch, as the reference's is plain XLA.
- `exact_rerank`: candidate rows gathered from the raw store and
  re-scored at f32.
- `int8_scan_rerank`: a scan and the rerank, the reference's fused
  default path (`storage` picks the int8 or the int4 scan).

The disk tier (index/disk.py) scans the probed slabs of the HBM bucket
cache (index/hbm_cache.py) with `cached_bucket_scan` — through the
probe-dots Hopper kernel on a CUDA tensor — and reranks against
host-gathered raw rows with `exact_rerank_gathered`. `note_tier_phase`
records the tier's host-side windows (slab fetch, prefetch scheduling,
pin recompute) in the phase ledger when one is installed, and on the
request's capture.

All selections take the lower index first among ties (`stable_topk`),
which is the `jax.lax.top_k` order.

Dispatch observation: `note_dispatch` feeds the optional process-wide
ledger, the optional dispatch observer (obs/accounting installs one, so
per-space dispatch counts reconcile with the ledger) and the calling
thread's per-request capture (`begin_capture` / `capture_mark` /
`end_capture`), which the engine folds into `trace["dispatches"]`.

Spans: `span(name)` is the one way the search path names a stretch of
its work. Under a running `torch.profiler` it opens a `record_function`
range of that name, so the device trace's kernels and idle gaps fall
under the program's names; on a traced request (a capture on the
thread) it adds a (name, start, end) host window to the capture, which
the engine turns into `_phase_spans` rows. A `device=True` span of a
traced request on a CUDA device also records a timing event pair on the
current stream, read into `trace["stream_ms"]`. With neither, a span
costs one check. On a traced request, `span_attrs` gives the innermost
open span attributes (`trace["span_attrs"]`, one entry a call).
docs/OBSERVABILITY_TORCH.md lists the names.
"""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.blockmax_scan import (
    BLOCK,
    blockmax_stage2,
    int8_blockmax_stage1,
)
from vearch_tpu_torch.ops.distance import NEG_INF, sqnorms, stable_topk

# Optional dispatch ledger: when a list is installed here, index call
# sites append one tag per search program they run, with the reference's
# tag names (fused_scan_rerank, pallas_blockmax_scan, scan, probe_scan,
# ivfflat_scan, rerank, flat_scan, binary_refine_rerank) so the two
# packages' ledgers compare line by line.
# The ledger is process-wide: searches the batch scheduler's thread runs
# note into it too, under a lock.
_dispatch_ledger: list | None = None
_ledger_lock = threading.Lock()


def set_dispatch_ledger(ledger: list | None) -> None:
    global _dispatch_ledger
    with _ledger_lock:
        _dispatch_ledger = ledger


# Optional dispatch observer (obs/accounting installs one): called as
# observer(tag) from the same note_dispatch call that feeds the ledger
# and the per-request capture.
_dispatch_observer = None


def set_dispatch_observer(fn) -> None:
    """Install (or clear, with None) the process-wide dispatch observer."""
    global _dispatch_observer
    _dispatch_observer = fn


# Per-request dispatch capture: a thread-local recorder beside the
# process-wide ledger. The engine installs one per traced search, so the
# trace reports which search programs this request ran and how long each
# took on the host's clock, without touching the index call sites. A
# tag's window closes at the next note_dispatch or at capture_mark() /
# end_capture(): the `kernel.{tag}` rows made of these windows are host
# time between two dispatch notes, not device time (the name is the
# reference's).
class _CaptureLocal(threading.local):
    # the class default makes a thread that never captured read None
    # without raising: a span's one check on an untraced path
    capture = None


_capture_tls = _CaptureLocal()


class DispatchCapture:
    __slots__ = ("attrs", "events", "spans", "stream", "stream_device")

    def __init__(self, device=None) -> None:
        # [tag, start_monotonic_s, end_monotonic_s | None]
        self.events: list[list] = []
        # [name, start_monotonic_s, end_monotonic_s | None] host windows
        # of the request's spans, in the order they opened
        self.spans: list[list] = []
        # (name, start event, end event) of its device spans, kept only
        # where `stream_device` is set (the engine's device is CUDA)
        self.stream: list[tuple] = []
        # [span name, {key: value}] a `span_attrs` call, in call order
        self.attrs: list[list] = []
        self.stream_device = (
            torch.device(device) if device is not None
            and torch.device(device).type == "cuda" else None)

    def note(self, tag: str) -> None:
        now = time.monotonic()
        if self.events and self.events[-1][2] is None:
            self.events[-1][2] = now
        self.events.append([tag, now, None])

    def mark(self) -> None:
        """Close the open dispatch window."""
        if self.events and self.events[-1][2] is None:
            self.events[-1][2] = time.monotonic()

    @property
    def tags(self) -> list[str]:
        return [e[0] for e in self.events]

    def stream_ms(self) -> dict[str, float]:
        """{span name: ms} on the stream from each device span's start to
        its last operation, summed by name; pairs not yet complete (a
        search that raised before its answer reached the host) are left
        out."""
        out: dict[str, float] = {}
        for name, start, end in self.stream:
            if end.query():
                out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def begin_capture(device=None) -> DispatchCapture:
    """Install a capture on the calling thread; `device` (the engine's)
    says whether device spans time the CUDA stream."""
    cap = DispatchCapture(device)
    _capture_tls.capture = cap
    return cap


def capture_mark() -> None:
    cap = _capture_tls.capture
    if cap is not None:
        cap.mark()


def end_capture() -> DispatchCapture | None:
    cap = _capture_tls.capture
    _capture_tls.capture = None
    if cap is not None:
        cap.mark()
    return cap


def note_dispatch(tag: str) -> None:
    with _ledger_lock:
        if _dispatch_ledger is not None:
            _dispatch_ledger.append(tag)
    obs = _dispatch_observer
    if obs is not None:
        obs(tag)
    cap = _capture_tls.capture
    if cap is not None:
        cap.note(tag)


class _Span:
    """An open span: a profiler range, a capture window, or both."""

    __slots__ = ("name", "cap", "device", "rf", "row", "start")

    def __init__(self, name: str, cap, device: bool, profiled: bool):
        self.name, self.cap = name, cap
        self.device = device and cap is not None \
            and cap.stream_device is not None
        self.rf = record_function(name) if profiled else None
        self.row = self.start = None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.device:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(
                self.cap.stream_device))
        self.row = [self.name, time.monotonic(), None]
        if self.cap is not None:
            self.cap.spans.append(self.row)
        return self

    def __exit__(self, *exc) -> bool:
        self.row[2] = time.monotonic()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.cap.stream_device))
            self.cap.stream.append((self.name, self.start, end))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    @property
    def ms(self) -> float:
        """The span's host window in ms, once closed."""
        return round((self.row[2] - self.row[1]) * 1e3, 3)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, device: bool = False):
    """A context manager naming the work inside it `name` (see the
    module's docstring): a profiler range while a profiler runs, and a
    window on the thread's capture of a traced request. `device=True`
    marks a stage of device work, whose stream time a traced request on
    a CUDA device also records. Without either it does nothing."""
    profiled = _autograd_profiler._is_profiler_enabled
    cap = _capture_tls.capture
    if cap is None and not profiled:
        return _NO_SPAN
    return _Span(name, cap, device, profiled)


def span_attrs(make) -> None:
    """On a traced request, give the innermost open span of the thread's
    capture the attributes `make()` returns ({key: value}), kept as one
    [span name, attributes] entry a call, so a span that runs a stage
    twice keeps both. A value may be a 0-d tensor, read when the engine
    folds the capture into the trace. Without a capture `make` is not
    called: one check."""
    cap = _capture_tls.capture
    if cap is None:
        return
    for row in reversed(cap.spans):
        if row[2] is None:
            cap.attrs.append([row[0], make()])
            return


# Optional tier-phase ledger: when a list is installed here, the tiered
# storage path appends (name, t0, t1) monotonic windows of its host-side
# work (fetch, prefetch, pin), from whichever thread ran it.
_tier_phase_ledger: list | None = None


def set_tier_phase_ledger(ledger: list | None) -> None:
    global _tier_phase_ledger
    with _ledger_lock:
        _tier_phase_ledger = ledger


def note_tier_phase(name: str, t0: float, t1: float) -> None:
    """Record a host-side window of the tiered-storage serving path
    (demand slab fetch, prefetch scheduling, pin-set recompute) in the
    ledger and, as a `tier.{name}` row, on the calling thread's capture.
    The window is known only once it has closed (the pin row is kept
    only when the pin set changed), so it opens no profiler range."""
    with _ledger_lock:
        if _tier_phase_ledger is not None:
            _tier_phase_ledger.append((name, t0, t1))
    cap = _capture_tls.capture
    if cap is not None:
        cap.spans.append([f"tier.{name}", t0, t1])


def coarse_dots(queries: torch.Tensor, centroids: torch.Tensor
                ) -> torch.Tensor:
    """[B, nlist] q . centroid at full f32 (TF32 is off: the reference's
    Precision.HIGHEST; a bf16 or TF32 product flips probes near ties)."""
    return torch.matmul(queries.float(), centroids.float().T)


def select_probes(qc: torch.Tensor, centroids: torch.Tensor,
                  nprobe: int) -> torch.Tensor:
    """Top-nprobe cells [B, nprobe] (int64, lower cell first on ties) by
    the L2 coarse score 2 q.c - |c|^2: coarse assignment is L2 geometry
    for every metric (IP/cosine data is normalized upstream)."""
    return stable_topk(2.0 * qc - sqnorms(centroids)[None, :], nprobe)[1]


def _coarse_probes(queries: torch.Tensor, centroids: torch.Tensor,
                   nprobe: int) -> torch.Tensor:
    """Top-nprobe cluster ids per query [B, nprobe] (int64)."""
    return select_probes(coarse_dots(queries, centroids), centroids, nprobe)


def _fold_topk(
    best: tuple[torch.Tensor, torch.Tensor],
    scores: torch.Tensor,
    ids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a new [B, c] candidate block into the running [B, r] top
    list; on ties the running list, then the lower slot, wins."""
    best_s, best_i = best
    top_s, pos = stable_topk(torch.cat([best_s, scores], dim=1),
                             best_s.shape[1])
    return top_s, torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)


def _probe_loop(queries, probes, r, score_step):
    """The reference's `lax.scan` over probe ranks: `score_step(c)` gives
    the [B, cap] scores of cell c[b] for each query; padded slots
    (c == -1) scan cell 0 fully masked. Returns ([B, r] scores, [B, r]
    int32 ids, -1 where the score is not finite)."""
    b = queries.shape[0]
    best = (torch.full((b, r), NEG_INF, device=queries.device),
            torch.full((b, r), -1, dtype=torch.int32, device=queries.device))
    for pr in range(probes.shape[1]):
        c = probes[:, pr].long()
        cell_ok = c >= 0
        scores, ids = score_step(torch.clamp(c, min=0))
        scores = torch.where(cell_ok[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        best = _fold_topk(best, scores, ids)
    best_s, best_i = best
    return best_s, torch.where(torch.isfinite(best_s), best_i,
                               torch.full_like(best_i, -1))


def _mask_slots(scores, ids, valid):
    ok = (ids >= 0) & valid[torch.clamp(ids, min=0).long()]
    return torch.where(ok, scores, torch.full_like(scores, NEG_INF))


@perf_model.register_op("ivf.ivfflat_candidates")
def ivfflat_candidates(
    queries: torch.Tensor,        # [B, d] store dtype
    centroids: torch.Tensor,      # [nlist, d] f32
    bucket_vecs: torch.Tensor,    # [nlist, cap, d] store dtype
    bucket_sqnorm: torch.Tensor,  # [nlist, cap] f32
    bucket_ids: torch.Tensor,     # [nlist, cap] int32
    valid: torch.Tensor,          # [n_pad] bool (docid-indexed)
    nprobe: int,
    r: int,
    metric: MetricType = MetricType.L2,
    probes: torch.Tensor | None = None,  # [B, nprobe] int32 (precomputed)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan nprobe buckets per query over the raw vectors; top-r
    (scores, docids)."""
    if probes is None:
        probes = _coarse_probes(queries.float(), centroids, nprobe)
    q_sq = sqnorms(queries)
    qf = queries.float()

    def step(c):
        ids = bucket_ids[c]  # [B, cap]
        dots = torch.bmm(bucket_vecs[c].float(), qf[:, :, None])[..., 0]
        if metric is MetricType.L2:
            scores = -(q_sq[:, None] - 2.0 * dots + bucket_sqnorm[c])
        else:
            scores = dots
        return _mask_slots(scores, ids, valid), ids

    return _probe_loop(queries, probes, r, step)


@perf_model.register_op("ivf.ivfpq_candidates")
def ivfpq_candidates(
    queries: torch.Tensor,        # [B, d] f32
    centroids: torch.Tensor,      # [nlist, d] f32
    bucket_resid8: torch.Tensor,  # [nlist, cap, d] int8 PQ-decoded residuals
    bucket_scale: torch.Tensor,   # [nlist] f32 per-cluster dequant scale
    bucket_vsq: torch.Tensor,     # [nlist, cap] f32 ||approx vector||^2
    bucket_ids: torch.Tensor,     # [nlist, cap] int32
    valid: torch.Tensor,          # [n_pad] bool
    nprobe: int,
    r: int,
    metric: MetricType = MetricType.L2,
    probes: torch.Tensor | None = None,  # [B, nprobe] int32 (precomputed)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's XLA probe scan over int8 residual buckets. Per
    probed cell c with approx v = cent_c + s_c * r8:
        q.v = q.cent_c + s_c * (q.r8);  L2 = -(|q|^2 - 2 q.v + |v|^2)
    (q.cent_c as an elementwise f32 sum, as the reference takes it)."""
    queries = queries.float()
    if probes is None:
        probes = _coarse_probes(queries, centroids, nprobe)
    q_sq = sqnorms(queries)
    qb = queries.to(torch.bfloat16).float()

    def step(c):
        ids = bucket_ids[c]
        dot8 = torch.bmm(bucket_resid8[c].float(), qb[:, :, None])[..., 0]
        qc = torch.sum(queries * centroids[c], dim=1)
        dots = qc[:, None] + bucket_scale[c][:, None] * dot8
        if metric is MetricType.L2:
            scores = -(q_sq[:, None] - 2.0 * dots + bucket_vsq[c])
        else:
            scores = dots
        return _mask_slots(scores, ids, valid), ids

    return _probe_loop(queries, probes, r, step)


def _int8_scores(queries, approx8, scale, vsq, valid, l2: bool):
    """Full [B, N_pad] int8-mirror score matrix (exact-selection branch)."""
    dots = torch.matmul(queries.to(torch.bfloat16).float(),
                        approx8.float().T) * scale[None, :]
    if l2:
        scores = -(sqnorms(queries)[:, None] - 2.0 * dots + vsq[None, :])
    else:
        scores = dots
    return torch.where(valid[None, :], scores,
                       torch.full_like(scores, NEG_INF))


def _select_topk(
    queries: torch.Tensor,
    approx8: torch.Tensor,
    scale: torch.Tensor,
    vsq: torch.Tensor,
    valid: torch.Tensor,
    r: int,
    topk_mode: str,
    l2: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-max / exact top-r selection over the int8 scores. The
    reference takes a materialised score matrix; here the block-max
    branch computes its stage 1 in the kernel instead, with the same
    gate, over-selection (2x+8 blocks) and bf16 block maxima."""
    n_pad = approx8.shape[0]
    r = min(r, n_pad)
    nb = max(32, r // 4)
    nblk = n_pad // BLOCK
    use_block = (
        n_pad % BLOCK == 0
        and nblk >= 1
        and (topk_mode == "blockmax"
             or (topk_mode == "auto" and nblk >= nb * 4))
    )
    if not use_block:
        with span("scan.matmul", device=True):
            scores = _int8_scores(queries, approx8, scale, vsq, valid, l2)
        with span("scan.select", device=True):
            return select_topk_scores(scores, r, "exact")
    nb = min(2 * nb + 8, nblk)
    with span("scan.blockmax", device=True):
        bmax = int8_blockmax_stage1(
            queries.to(torch.bfloat16).contiguous(), approx8, scale, vsq,
            valid, sqnorms(queries).contiguous(), l2)
    with span("scan.refine", device=True):
        return blockmax_stage2(queries, approx8, scale, vsq, valid, bmax,
                               nb, min(r, nb * BLOCK), l2)


SELECT_CHUNK = 128  # queries per stage-2 gather of `select_topk_scores`


def select_topk_scores(
    scores: torch.Tensor,  # [B, N_pad] f32, -inf where masked
    r: int,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-r over a materialised score matrix, the reference's
    `_select_topk`: the same block-max gate as the int8 `_select_topk`,
    bf16-rounded 512-row block maxima, the top min(2 nb + 8, nblk)
    blocks, then the top-r of those blocks' f32 scores (gathered
    SELECT_CHUNK queries at a time). Returns ([B, r] scores, [B, r]
    int32 ids, -1 where the score is not finite)."""
    b, n_pad = scores.shape
    r = min(r, n_pad)
    nb = max(32, r // 4)
    nblk = n_pad // BLOCK
    use_block = (
        n_pad % BLOCK == 0
        and nblk >= 1
        and (topk_mode == "blockmax"
             or (topk_mode == "auto" and nblk >= nb * 4))
    )
    if not use_block:
        top_s, ids = stable_topk(scores, r)
        ids = ids.to(torch.int32)
    else:
        nb = min(2 * nb + 8, nblk)
        s3f = scores.view(b, nblk, BLOCK)
        # bf16 rounding is monotone: the rounded max is the max of the
        # rounded scores, without a bf16 copy of the matrix
        bmax = s3f.amax(-1).to(torch.bfloat16).float()  # [B, nblk]
        top_blocks = stable_topk(bmax, nb)[1]            # [B, nb]
        r = min(r, nb * BLOCK)
        top_s = torch.empty((b, r), dtype=torch.float32, device=scores.device)
        ids = torch.empty((b, r), dtype=torch.int32, device=scores.device)
        for lo in range(0, b, SELECT_CHUNK):
            hi = min(lo + SELECT_CHUNK, b)
            blocks = top_blocks[lo:hi]
            gathered = torch.gather(
                s3f[lo:hi], 1, blocks[:, :, None].expand(-1, -1, BLOCK))
            s, pos = stable_topk(gathered.reshape(hi - lo, nb * BLOCK), r)
            top_s[lo:hi] = s
            ids[lo:hi] = (torch.gather(blocks, 1, pos // BLOCK) * BLOCK
                          + pos % BLOCK)
    # masked slots (filtered/deleted/padding) carry -inf: id -1 so the
    # rerank cannot resurrect them
    return top_s, torch.where(torch.isfinite(top_s), ids,
                              torch.full_like(ids, -1))


@perf_model.register_op("ivf.int8_scan_candidates")
def int8_scan_candidates(
    queries: torch.Tensor,  # [B, d] f32
    approx8: torch.Tensor,  # [N_pad, d] int8 docid-ordered mirror
    scale: torch.Tensor,    # [N_pad] f32 per-row dequant scale
    vsq: torch.Tensor,      # [N_pad] f32 ||approx||^2
    valid: torch.Tensor,    # [N_pad] bool
    r: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed full scan + top-r: ([B, r] f32 scores, [B, r] int32
    docids, -1 for masked)."""
    return _select_topk(queries.float(), approx8, scale, vsq, valid, r,
                        topk_mode, metric is MetricType.L2)


#: spans of the int4 full scan, in order (`int8_scan_rerank` with storage
#: "int4"): chip_smoke.py splits a search's device time by their ranges
INT4_RANGES = ("scan.unpack", "scan.matmul", "scan.epilogue",
               "scan.select", "scan.rerank")


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, d/2] uint8 nibble-packed -> [N, d] int8 signed values in
    [-8, 7]. Layout contract (index/int8_mirror.py quantize_rows_int4):
    dims [0, d/2) in the low nibble, [d/2, d) in the high one."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = lo - (lo > 7).to(torch.int8) * 16
    hi = hi - (hi > 7).to(torch.int8) * 16
    return torch.cat([lo, hi], dim=-1)


@perf_model.register_op("ivf.int4_scan_candidates")
def int4_scan_candidates(
    queries: torch.Tensor,  # [B, d] f32
    packed4: torch.Tensor,  # [N_pad, d/2] uint8 nibble-packed int4 rows
    scale: torch.Tensor,    # [N_pad] f32 per-row dequant scale
    vsq: torch.Tensor,      # [N_pad] f32 ||approx||^2
    valid: torch.Tensor,    # [N_pad] bool
    r: int,
    metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 mirror's full scan + top-r ([B, r] f32 scores, [B, r]
    int32 docids, -1 for masked), through the materialised [B, N_pad]
    score matrix and the reference's selection (`select_topk_scores`).

    The scores are bf16 q . int4 row at f32, x scale, L2/IP, -inf where
    masked. Every product of a bf16 value and an int4 value is exact in
    f32, so the matrix is the reference's `preferred_element_type=f32`
    product up to the order of the sums over d; TF32 must be off for
    that (it would round the queries to 10 bits of mantissa). The
    epilogue runs in place on the matrix, in the reference's operation
    order."""
    if queries.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the int4 scan needs exact f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    queries = queries.float()
    with span("scan.unpack", device=True):
        vals = unpack_int4(packed4).float()  # [N, d]
    with span("scan.matmul", device=True):
        scores = torch.matmul(queries.to(torch.bfloat16).float(), vals.T)
    del vals
    with span("scan.epilogue", device=True):
        scores.mul_(scale[None, :])
        if metric is MetricType.L2:
            scores.mul_(-2.0).add_(sqnorms(queries)[:, None])
            scores.add_(vsq[None, :]).neg_()
        scores.masked_fill_(~valid[None, :], NEG_INF)
    with span("scan.select", device=True):
        return select_topk_scores(scores, r, topk_mode)


@perf_model.register_op("ivf.exact_rerank")
def exact_rerank(
    queries: torch.Tensor,      # [B, d] (store dtype)
    cand_ids: torch.Tensor,     # [B, r] int32 (-1 padding)
    base: torch.Tensor,         # [capacity, d] store dtype
    base_sqnorm: torch.Tensor,  # [capacity] f32
    k: int,
    metric: MetricType = MetricType.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of candidate docids against the raw device
    buffer: one row gather + a batched f32 product."""
    scores = rerank_scores(queries, torch.clamp(cand_ids, min=0), base,
                           base_sqnorm, metric)
    scores = torch.where(cand_ids >= 0, scores,
                         torch.full_like(scores, NEG_INF))
    top_s, pos = stable_topk(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(cand_ids, 1, pos)


def rerank_scores(
    queries: torch.Tensor,      # [B, d] (store dtype)
    rows: torch.Tensor,         # [B, r] row numbers into base, all >= 0
    base: torch.Tensor,         # [capacity, d] store dtype
    base_sqnorm: torch.Tensor,  # [capacity] f32
    metric: MetricType,
) -> torch.Tensor:
    """[B, r] exact scores of the given base rows: the gather and the
    batched f32 product of `exact_rerank`, which the mesh's rerank
    (parallel/sharded.py) shares."""
    safe = rows.long()
    vecs = base[safe].float()  # [B, r, d]
    vsq = base_sqnorm[safe]    # [B, r]
    dots = torch.bmm(vecs, queries.float()[:, :, None])[..., 0]
    if metric is MetricType.L2:
        return -(sqnorms(queries)[:, None] - 2.0 * dots + vsq)
    if metric is MetricType.COSINE:
        qn = torch.sqrt(torch.clamp(sqnorms(queries), min=1e-30))[:, None]
        vn = torch.sqrt(torch.clamp(vsq, min=1e-30))
        return dots / (qn * vn)
    return dots


@perf_model.register_op("ivf.exact_rerank_gathered")
def exact_rerank_gathered(
    queries: torch.Tensor,    # [B, d] f32
    cand_ids: torch.Tensor,   # [B, r] int32 (-1 padding)
    cand_vecs: torch.Tensor,  # [B, r, d] f32, host-gathered raw rows
    k: int,
    metric: MetricType = MetricType.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank when the raw base lives on disk: the candidate rows
    were gathered on the host and uploaded as one [B, r, d] tensor, the
    only H2D traffic the disk tier pays a query batch."""
    dots = torch.bmm(cand_vecs.float(), queries.float()[:, :, None])[..., 0]
    vsq = sqnorms(cand_vecs)
    if metric is MetricType.L2:
        scores = -(sqnorms(queries)[:, None] - 2.0 * dots + vsq)
    elif metric is MetricType.COSINE:
        qn = torch.sqrt(torch.clamp(sqnorms(queries), min=1e-30))[:, None]
        vn = torch.sqrt(torch.clamp(vsq, min=1e-30))
        scores = dots / (qn * vn)
    else:
        scores = dots
    scores = torch.where(cand_ids >= 0, scores,
                         torch.full_like(scores, NEG_INF))
    top_s, pos = stable_topk(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(cand_ids, 1, pos)


@perf_model.register_op("ivf.cached_bucket_scan")
def cached_bucket_scan(
    queries: torch.Tensor,      # [B, d] f32
    pool8: torch.Tensor,        # [slots, cap, d] int8 (HBM bucket cache)
    pool_scale: torch.Tensor,   # [slots, cap] f32 per-row dequant scale
    pool_vsq: torch.Tensor,     # [slots, cap] f32 ||approx||^2
    pool_ids: torch.Tensor,     # [slots, cap] int32 docids (-1 padding)
    probe_slots: torch.Tensor,  # [B, nprobe] int32 cache slot, -1 deferred
    valid: torch.Tensor,        # [n_pad] bool (docid-indexed)
    r: int,
    metric: MetricType = MetricType.L2,
    pool_lens: torch.Tensor | None = None,  # [slots] int32 live rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe scan over the HBM bucket cache (the disk tier's search).

    The rows are per-row-scaled int8 approximations of full vectors (no
    centroid term): score = f(scale * (bf16 q . int8 row)). A slot of -1
    marks a probe deferred to another pass of a multi-pass resolve; its
    slab is masked whole. Returns ([B, r] scores, [B, r] int32 docids,
    -1 where the score is not finite).

    A CUDA tensor takes the probe-dots kernel (`cached_bucket_scan_dots`);
    a CPU tensor runs the reference's per-probe loop (`_probe_loop`)."""
    if queries.device.type != "cpu":
        return cached_bucket_scan_dots(
            queries, pool8, pool_scale, pool_vsq, pool_ids, probe_slots,
            valid, r, metric, pool_lens)
    queries = queries.float()
    q_sq = sqnorms(queries)
    qb = queries.to(torch.bfloat16).float()
    l2 = metric is MetricType.L2

    def step(s):
        ids = pool_ids[s]  # [B, cap]
        dot8 = torch.bmm(pool8[s].float(), qb[:, :, None])[..., 0]
        dots = pool_scale[s] * dot8
        scores = -(q_sq[:, None] - 2.0 * dots + pool_vsq[s]) if l2 \
            else dots
        return _mask_slots(scores, ids, valid), ids

    return _probe_loop(queries, probe_slots, r, step)


def cached_bucket_scan_dots(
    queries, pool8, pool_scale, pool_vsq, pool_ids, probe_slots, valid,
    r, metric=MetricType.L2, pool_lens=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`cached_bucket_scan` through `ops/probe_dots.ivf_probe_dots` (the
    Hopper kernel on a CUDA tensor, its plain version on a CPU one; slots
    in the place of cells, `pool_lens` letting it skip each slab's
    padding), then the scale, the L2/IP epilogue, the mask and one
    stable top-r over the probe-major flattening, which is the
    reference's per-probe fold (the running list, then the lower slot,
    wins a tie)."""
    from vearch_tpu_torch.ops.probe_dots import ivf_probe_dots

    queries = queries.float()
    b, nprobe, cap = queries.shape[0], probe_slots.shape[1], pool8.shape[1]
    dot8 = ivf_probe_dots(queries.to(torch.bfloat16).contiguous(),
                          probe_slots.to(torch.int32).contiguous(), pool8,
                          pool_lens)  # [B, nprobe, cap]
    s = torch.clamp(probe_slots, min=0).long()
    dots = pool_scale[s] * dot8
    if metric is MetricType.L2:
        scores = -(sqnorms(queries)[:, None, None] - 2.0 * dots
                   + pool_vsq[s])
    else:
        scores = dots
    ids = pool_ids[s]  # [B, nprobe, cap]
    ok = ((probe_slots >= 0)[:, :, None] & (ids >= 0)
          & valid[torch.clamp(ids, min=0).long()])
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    top_s, pos = stable_topk(scores.reshape(b, nprobe * cap),
                             min(r, nprobe * cap))
    top_i = torch.gather(ids.reshape(b, nprobe * cap), 1, pos)
    if top_s.shape[1] < r:  # the fold keeps r slots, -inf past the data
        pad = r - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, torch.where(torch.isfinite(top_s), top_i,
                              torch.full_like(top_i, -1))


@perf_model.register_op("ivf.int8_scan_rerank")
def int8_scan_rerank(
    queries: torch.Tensor,      # [B, d] f32
    approx8: torch.Tensor,
    row_scale: torch.Tensor,
    row_vsq: torch.Tensor,
    valid: torch.Tensor,
    base: torch.Tensor,         # [capacity, d] raw store buffer
    base_sqnorm: torch.Tensor,  # [capacity] f32
    r: int,
    k: int,
    scan_metric: MetricType = MetricType.L2,
    rerank_metric: MetricType = MetricType.L2,
    topk_mode: str = "auto",
    storage: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed scan + exact rerank; only the final [B, k] pair leaves
    the device. scan_metric is the compressed-domain metric (cosine scans
    as IP on pre-normalized rows), rerank_metric the user-facing one;
    `storage` is the mirror's ("int8", or "int4" with approx8 the
    [N_pad, d/2] packed rows)."""
    scan = int8_scan_candidates if storage == "int8" \
        else int4_scan_candidates
    _, cand_i = scan(queries, approx8, row_scale, row_vsq, valid, r,
                     scan_metric, topk_mode)
    with span("scan.rerank", device=True):
        return exact_rerank(queries.to(base.dtype), cand_i, base,
                            base_sqnorm, k, rerank_metric)
