"""IVF probe scan: the port of vearch_tpu/ops/pallas_kernels.py's
`ivf_probe_dots` and `ivfpq_probe_search_pallas`.

`ivf_probe_dots` gives the raw dot products of each bf16-rounded query
with every row of each bucket it probes: [B, nprobe, cap] f32, 0 at and
past the bucket's live length where `lens` (the index's published
`_bucket_lens`) is given. On a CUDA tensor it launches the hand-written
Hopper kernel in csrc/probe_dots.cu, which groups the (query, probe)
pairs by bucket (`group_pairs`, on the device) and reads no row past a
bucket's length;
on a CPU tensor it runs the plain PyTorch version
`ivf_probe_dots_reference`. There is no fallback from one to the other: a
CUDA tensor launches the kernel or raises.

`ivfpq_probe_search` is the probe-regime IVFPQ search around it: probe
selection at full f32 precision, the kernel, then the score assembly,
masking and one top-r over nprobe*cap slots in PyTorch, as they stayed
XLA in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops._cuda_build import CudaLibrary, count_launch
from vearch_tpu_torch.ops.distance import NEG_INF, sqnorms, stable_topk
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops.ivf import coarse_dots, select_probes

PLAIN_CHUNK = 32  # queries per gather in the plain version
MAX_SEGMENTS = 65535  # the kernel's grid y: nlist + 1 segments

LIBRARY = CudaLibrary("probe_dots.cu", {
    "vt_ivf_probe_dots":
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
})


def ivf_probe_dots_reference(
    qb: torch.Tensor,       # [B, d] bf16
    probes: torch.Tensor,   # [B, nprobe] int32
    buckets: torch.Tensor,  # [nlist, cap, d] int8
    lens: torch.Tensor | None = None,  # [nlist] int32 live rows per bucket
) -> torch.Tensor:
    """Plain PyTorch probe dots: gather the probed buckets and take the
    f32 product with the widened bf16 queries, 32 queries at a time (the
    f32 gather of all of them would be B*nprobe*cap*d*4 bytes). A probe
    id < 0 gives zeros, and so does a row at or past its bucket's
    `lens` entry (`lens=None`: every row is live)."""
    b, d = qb.shape
    nprobe = probes.shape[1]
    cap = buckets.shape[1]
    out = torch.empty((b, nprobe, cap), dtype=torch.float32,
                      device=qb.device)
    rows = torch.arange(cap, device=qb.device)
    for lo in range(0, b, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, b)
        p = probes[lo:hi].long()
        pc = torch.clamp(p, min=0)
        vecs = buckets[pc].float()  # [c, nprobe, cap, d]
        dots = torch.matmul(vecs, qb[lo:hi].float()[:, None, :, None])
        keep = (p >= 0)[:, :, None]
        if lens is not None:
            keep = keep & (rows < lens[pc][:, :, None])
        out[lo:hi] = torch.where(keep, dots[..., 0],
                                 torch.zeros((), device=qb.device))
    return out


def group_pairs(probes: torch.Tensor, nlist: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work list, built on the probes' device without a
    host read: the B*nprobe pair indices (i*nprobe + j) stably sorted by
    probe id, and [nlist + 2] segment offsets (bucket c's pairs are
    order[offs[c]:offs[c+1]]; segment nlist holds the ids < 0 or >=
    nlist). Both int32."""
    flat = probes.reshape(-1)
    key = torch.where((flat >= 0) & (flat < nlist), flat,
                      torch.full_like(flat, nlist))
    order = torch.argsort(key, stable=True)
    offs = torch.searchsorted(
        key[order], torch.arange(nlist + 2, dtype=key.dtype,
                                 device=key.device), out_int32=True)
    return order.to(torch.int32), offs


def _check_inputs(qb, probes, buckets, lens) -> None:
    dev = qb.device
    named = [("qb", qb, torch.bfloat16, 2), ("probes", probes, torch.int32, 2),
             ("buckets", buckets, torch.int8, 3)]
    if lens is not None:
        named.append(("lens", lens, torch.int32, 1))
    for name, t, dtype, ndim in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qb on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must have {ndim} dimensions")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, d = qb.shape
    nlist = buckets.shape[0]
    if probes.shape[0] != b:
        raise ValueError(f"probes must be [{b}, nprobe], got "
                         f"{tuple(probes.shape)}")
    if buckets.shape[2] != d:
        raise ValueError(f"buckets must be [nlist, cap, {d}], got "
                         f"{tuple(buckets.shape)}")
    if lens is not None and lens.shape[0] != nlist:
        raise ValueError(f"lens must be [{nlist}], got {tuple(lens.shape)}")
    if nlist + 1 > MAX_SEGMENTS:
        raise ValueError(f"nlist={nlist} exceeds the kernel's "
                         f"{MAX_SEGMENTS - 1}")
    if b * probes.shape[1] >= 2 ** 31:
        raise ValueError("B * nprobe exceeds the kernel's int32 pair ids")
    # reading the ids back would make the host wait for the card; there
    # the kernel writes zeros for an id >= nlist, as for a padded slot
    if dev.type == "cpu" and bool((probes >= nlist).any()):
        raise ValueError(f"a probe id is >= nlist={nlist}")


@perf_model.register_op("kernel.ivf_probe_dots")
def ivf_probe_dots(
    qb: torch.Tensor,       # [B, d] bf16
    probes: torch.Tensor,   # [B, nprobe] int32, < 0 for a padded slot
    buckets: torch.Tensor,  # [nlist, cap, d] int8
    lens: torch.Tensor | None = None,  # [nlist] int32, None = all of cap
) -> torch.Tensor:
    """Raw dots q_i . buckets[probes[i, j]] for every probed bucket:
    [B, nprobe, cap] f32, 0 at and past each bucket's live length. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_inputs(qb, probes, buckets, lens)
    if qb.device.type == "cpu":
        return ivf_probe_dots_reference(qb, probes, buckets, lens)
    if qb.device.type != "cuda":
        raise ValueError(f"unsupported device {qb.device}")
    if lens is None:
        nlist, cap = buckets.shape[:2]
        lens = torch.full((nlist,), cap, dtype=torch.int32,
                          device=qb.device)
    with torch.cuda.device(qb.device):
        order, offs = group_pairs(probes, buckets.shape[0])
    return launch_grouped(qb, order, offs, lens, buckets, probes.shape[1])


def launch_grouped(
    qb: torch.Tensor,       # [B, d] bf16, cuda
    order: torch.Tensor,    # [B * nprobe] int32, from group_pairs
    offs: torch.Tensor,     # [nlist + 2] int32, from group_pairs
    lens: torch.Tensor,     # [nlist] int32
    buckets: torch.Tensor,  # [nlist, cap, d] int8
    nprobe: int,
) -> torch.Tensor:
    """The kernel alone, on a work list `group_pairs` built: what
    `ivf_probe_dots` launches after grouping the pairs. Inputs are as
    `ivf_probe_dots` checked them."""
    lib = LIBRARY.load()
    b, d = qb.shape
    nlist, cap = buckets.shape[:2]
    out = torch.empty((b, nprobe, cap), dtype=torch.float32,
                      device=qb.device)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream(qb.device).cuda_stream
        err = lib.vt_ivf_probe_dots(
            qb.data_ptr(), order.data_ptr(), offs.data_ptr(),
            lens.data_ptr(), buckets.data_ptr(), out.data_ptr(), b, nprobe,
            nlist, cap, d, stream,
        )
    if err != 0:
        raise RuntimeError(f"probe_dots kernel launch failed: "
                           f"cudaError {err}")
    count_launch(ivf_probe_dots)
    return out


#: kernel launches since the counter was last set to 0 (CPU calls, which
#: run the plain version, do not count)
ivf_probe_dots.launches = 0


def ivfpq_probe_search(
    queries: torch.Tensor,        # [B, d] f32
    centroids: torch.Tensor,      # [nlist, d] f32
    bucket_resid8: torch.Tensor,  # [nlist, cap, d] int8
    bucket_scale: torch.Tensor,   # [nlist] f32
    bucket_vsq: torch.Tensor,     # [nlist, cap] f32
    bucket_ids: torch.Tensor,     # [nlist, cap] int32, -1 = padding
    valid: torch.Tensor,          # [n_pad] bool (docid-indexed)
    nprobe: int,
    r: int,
    l2: bool = True,
    bucket_lens: torch.Tensor | None = None,  # [nlist] int32 live rows
    probes: torch.Tensor | None = None,  # [B, nprobe] int32, -1 = no cell
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe-mode IVFPQ search: top-nprobe coarse cells (or the given
    `probes`, the HNSW coarse quantizer's host selection), the probe-dots
    kernel over them, then the top-r of the assembled scores. A probe
    slot of -1 reaches the kernel as it is (it writes zeros there) and
    its slots score -inf here.

    Per probed cell c, with approx v = cent_c + s_c * r8:
        q.v = q.cent_c + s_c * (q.r8);  L2 = -(|q|^2 - 2 q.v + |v|^2)

    `bucket_lens` (each cell's member count) lets the kernel skip the
    padding; the padded slots carry id -1 either way, so the answers do
    not change with it.

    Returns ([B, r] scores, [B, r] int32 docids). A masked slot's id is
    -1, as the reference's XLA arm (`ivfpq_candidates`) returns it; the
    reference's Pallas arm leaves the masked slot's docid beside its -inf
    score, which the exact rerank would score again."""
    queries = queries.float()
    b = queries.shape[0]
    cap = bucket_resid8.shape[1]
    with ivf_ops.span("scan.coarse", device=True):
        qc = coarse_dots(queries, centroids)  # [B, nlist], reused below
        if probes is None:
            probes = select_probes(qc, centroids, nprobe)  # [B, nprobe]
    nprobe = probes.shape[1]
    with ivf_ops.span("scan.probe_dots", device=True):
        dots8 = ivf_probe_dots(queries.to(torch.bfloat16).contiguous(),
                               probes.to(torch.int32).contiguous(),
                               bucket_resid8, bucket_lens)  # [B, nprobe, cap]
    with ivf_ops.span("scan.assemble", device=True):
        pc = torch.clamp(probes, min=0).long()
        qc_p = torch.gather(qc, 1, pc)
        scale_p = bucket_scale[pc]
        dots = qc_p[:, :, None] + scale_p[:, :, None] * dots8
        ids_p = bucket_ids[pc]  # [B, nprobe, cap]
        if l2:
            scores = -(sqnorms(queries)[:, None, None] - 2.0 * dots
                       + bucket_vsq[pc])
        else:
            scores = dots
        ok = ((probes >= 0)[:, :, None] & (ids_p >= 0)
              & valid[torch.clamp(ids_p, min=0).long()])
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    with ivf_ops.span("scan.select", device=True):
        top_s, pos = stable_topk(scores.reshape(b, nprobe * cap),
                                 min(r, nprobe * cap))
        ids = torch.gather(ids_p.reshape(b, nprobe * cap), 1, pos)
        return top_s, torch.where(torch.isfinite(top_s), ids,
                                  torch.full_like(ids, -1))
