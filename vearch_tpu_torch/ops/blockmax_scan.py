"""Block-max int8 full scan: the port of
vearch_tpu/ops/pallas_kernels.py::int8_blockmax_scan_pallas.

Stage 1 (`int8_blockmax_stage1`) scores every (query, mirror row) pair
and keeps only each 512-row block's maximum, rounded through bf16:
[B, N_pad/512] f32. Stage 2 (`blockmax_stage2`) picks the top blocks
per query, re-scores their rows at f32 (bf16 x int8 products are exact
in f32, TF32 is off) and takes the top-r. The reference ran stage 2 as
XLA ops; here its re-score is a kernel too (`blockmax_stage2_rescore`),
which reads the selected blocks straight from the int8 mirror and writes
only the [B, nb_sel * 512] f32 scores, in the layout the plain version
builds, so the stable top-r that follows breaks ties as it did.

On a CUDA tensor each stage launches its hand-written Hopper kernel in
csrc/blockmax_scan.cu; on a CPU tensor it runs its plain PyTorch
version (`int8_blockmax_stage1_reference`, `blockmax_stage2_reference`).
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

The kernels are built with nvcc at first use into vearch_tpu_torch/_build/
through ops/_cuda_build.py (`LIBRARY.load()`).

On a traced request each launch gives the span it runs in (`scan.blockmax`,
`scan.refine`) the attributes `query_tile` and `mirror_bytes`: the int8
mirror bytes it streamed, each row's d codes, scale and |v|^2 (d + 8
bytes) once per query tile that walked it (`stage1_mirror_bytes` from
the shapes; `stage2_mirror_bytes` from the tile map, on the device). An
untraced launch counts nothing beyond `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops._cuda_build import CudaLibrary, count_launch
from vearch_tpu_torch.ops.distance import NEG_INF, sqnorms, stable_topk

BLOCK = 512  # rows per block maximum (ops/ivf.py BLOCK)
STAGE2_CHUNK = 32  # queries per gather of the plain stage 2
# scores per sort of the kernel path's top-r: a sort of [rows, S] takes
# ~44 bytes an element at its peak on an H100 (torch's stable segmented
# sort), so 2^25 keeps it near 1.5 GB; at the main path's S (135,168)
# that is 248 queries a sort, 11.9 ms a 1,024-query batch against 13.8
# ms in sorts of 32
STAGE2_SORT_ELEMS = 1 << 25
MASKED = -3.4e38  # stage-1 score of an invalid row (the reference's value)
QUERY_TILES = (128, 64, 8)  # the kernel's wgmma N widths, widest first
MAX_QUERY_SMEM = 200 * 1024  # bytes of the query tile in shared memory

LIBRARY = CudaLibrary("blockmax_scan.cu", {
    "vt_int8_blockmax_stage1":
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "vt_blockmax_stage2":
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
})


def query_tile(b: int, d: int) -> int:
    """The kernel's query-tile width for a batch of `b` queries of
    dimension `d`: the narrowest of QUERY_TILES that holds the batch,
    narrowed further while the tile (d rounded up to 64, bf16) would pass
    MAX_QUERY_SMEM."""
    dpad = -(-d // 64) * 64
    fits = [n for n in QUERY_TILES if n * dpad * 2 <= MAX_QUERY_SMEM]
    if not fits:
        raise ValueError(f"d={d} exceeds the kernel's query tile "
                         f"({MAX_QUERY_SMEM} bytes at 8 queries)")
    for n in reversed(fits):
        if n >= b:
            return n
    return fits[0]


def stage1_mirror_bytes(b: int, n_pad: int, d: int) -> int:
    """Mirror bytes one stage-1 launch streams: every query tile walks
    all N_pad rows, d int8 codes and the f32 scale and |v|^2 a row."""
    return -(-b // query_tile(b, d)) * n_pad * (d + 8)


def stage2_mirror_bytes(active: torch.Tensor, d: int) -> torch.Tensor:
    """Mirror bytes one stage-2 launch streams, as a 0-d int64 tensor on
    `active`'s device: each (query tile, block) pair the tile map lets
    through reads the block's 512 rows of d + 8 bytes."""
    return active.sum(dtype=torch.int64) * (BLOCK * (d + 8))


def int8_blockmax_stage1_reference(
    qb: torch.Tensor,      # [B, d] bf16
    approx8: torch.Tensor,  # [N_pad, d] int8, N_pad % 512 == 0
    scale: torch.Tensor,    # [N_pad] f32
    vsq: torch.Tensor,      # [N_pad] f32
    valid: torch.Tensor,    # [N_pad] bool
    qsq: torch.Tensor,      # [B] f32
    l2: bool,
) -> torch.Tensor:
    """Plain PyTorch stage 1: the full [B, N_pad] score matrix at f32
    (bf16 operands widened, TF32 off), then bf16-rounded block maxima."""
    b = qb.shape[0]
    nblk = approx8.shape[0] // BLOCK
    dots = torch.matmul(qb.float(), approx8.float().T) * scale[None, :]
    if l2:
        scores = -(qsq[:, None] - 2.0 * dots + vsq[None, :])
    else:
        scores = dots
    scores = torch.where(valid[None, :], scores,
                         torch.full_like(scores, MASKED))
    return scores.reshape(b, nblk, BLOCK).to(torch.bfloat16).amax(-1).float()


def _check_scan_inputs(qb, approx8, scale, vsq, valid, qsq) -> None:
    dev = qb.device
    named = {"qb": qb, "approx8": approx8, "scale": scale, "vsq": vsq,
             "valid": valid, "qsq": qsq}
    want = {"qb": torch.bfloat16, "approx8": torch.int8,
            "scale": torch.float32, "vsq": torch.float32,
            "valid": torch.bool, "qsq": torch.float32}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qb on {dev}")
        if t.dtype != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, d = qb.shape
    n_pad = approx8.shape[0]
    if approx8.ndim != 2 or approx8.shape[1] != d:
        raise ValueError(f"approx8 must be [N_pad, {d}], got "
                         f"{tuple(approx8.shape)}")
    if n_pad % BLOCK:
        raise ValueError(f"N_pad={n_pad} must be a multiple of {BLOCK}")
    for name in ("scale", "vsq", "valid"):
        if tuple(named[name].shape) != (n_pad,):
            raise ValueError(f"{name} must be [{n_pad}]")
    if tuple(qsq.shape) != (b,):
        raise ValueError(f"qsq must be [{b}]")


@perf_model.register_op("kernel.int8_blockmax_stage1")
def int8_blockmax_stage1(
    qb: torch.Tensor,
    approx8: torch.Tensor,
    scale: torch.Tensor,
    vsq: torch.Tensor,
    valid: torch.Tensor,
    qsq: torch.Tensor,
    l2: bool,
) -> torch.Tensor:
    """Stage-1 block maxima [B, N_pad/512] f32 (arguments as for
    `int8_blockmax_stage1_reference`). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_scan_inputs(qb, approx8, scale, vsq, valid, qsq)
    if qb.device.type == "cpu":
        return int8_blockmax_stage1_reference(qb, approx8, scale, vsq,
                                              valid, qsq, l2)
    if qb.device.type != "cuda":
        raise ValueError(f"unsupported device {qb.device}")
    b, d = qb.shape
    n_tile = query_tile(b, d)
    lib = LIBRARY.load()
    nblk = approx8.shape[0] // BLOCK
    out = torch.empty((b, nblk), dtype=torch.float32, device=qb.device)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream(qb.device).cuda_stream
        err = lib.vt_int8_blockmax_stage1(
            qb.data_ptr(), approx8.data_ptr(), scale.data_ptr(),
            vsq.data_ptr(), valid.data_ptr(), qsq.data_ptr(),
            out.data_ptr(), b, d, nblk, int(bool(l2)), n_tile, stream,
        )
    if err != 0:
        raise RuntimeError(f"blockmax_scan kernel launch failed: "
                           f"cudaError {err}")
    count_launch(int8_blockmax_stage1)
    ivf_ops.span_attrs(lambda: {
        "query_tile": n_tile,
        "mirror_bytes": stage1_mirror_bytes(b, approx8.shape[0], d)})
    return out


#: kernel launches since the counter was last set to 0 (CPU calls, which
#: run the plain version, do not count)
int8_blockmax_stage1.launches = 0


def blockmax_stage2_reference(
    queries: torch.Tensor,  # [B, d] f32
    approx8: torch.Tensor,
    scale: torch.Tensor,
    vsq: torch.Tensor,
    valid: torch.Tensor,
    bmax: torch.Tensor,     # [B, nblk] stage-1 block maxima
    nb_sel: int,
    rr: int,
    l2: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch stage 2 (arguments and results as for
    `blockmax_stage2`): gathers the selected blocks' rows STAGE2_CHUNK
    queries at a time, widens them to f32 and re-scores them with one
    f32 product a query."""
    b, d = queries.shape
    nblk = approx8.shape[0] // BLOCK
    _, top_blocks = stable_topk(bmax, nb_sel)  # [B, nb_sel]
    qb = queries.to(torch.bfloat16).float()
    qsq = sqnorms(queries)
    offs = torch.arange(BLOCK, device=queries.device)
    # gather whole 512-row blocks (512*d contiguous bytes, moved as int64
    # words) rather than single int8 elements; the row order is the same:
    # block-major, then offset within the block
    words = approx8.view(nblk, BLOCK * d).view(torch.int64)
    out_s, out_i = [], []
    for lo in range(0, b, STAGE2_CHUNK):
        hi = min(lo + STAGE2_CHUNK, b)
        blocks = top_blocks[lo:hi]
        s = nb_sel * BLOCK
        idx = (blocks[:, :, None] * BLOCK + offs).reshape(hi - lo, s)
        vecs = torch.index_select(words, 0, blocks.reshape(-1)).view(
            torch.int8).reshape(hi - lo, s, d).float()  # [c, S, d]
        dots = torch.bmm(vecs, qb[lo:hi, :, None])[..., 0] \
            * scale.view(nblk, BLOCK)[blocks].reshape(hi - lo, s)
        if l2:
            scores = -(qsq[lo:hi, None] - 2.0 * dots
                       + vsq.view(nblk, BLOCK)[blocks].reshape(hi - lo, s))
        else:
            scores = dots
        ok = valid.view(nblk, BLOCK)[blocks].reshape(hi - lo, s)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        top_s, pos = stable_topk(scores, rr)
        out_s.append(top_s)
        out_i.append(torch.gather(idx, 1, pos))
    top_s = torch.cat(out_s)
    ids = torch.cat(out_i).to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), ids,
                              torch.full_like(ids, -1))


def stage2_maps(top_blocks: torch.Tensor, nblk: int,
                n_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stage-2 kernel's view of the selection `top_blocks` [B, nb_sel]
    (distinct blocks a query): `slots` [nblk, B] int32, the place of
    block j in query q's list at (j, q), -1 where q did not select j (one
    scatter; block-major, so the CTAs of a block read their queries'
    entries side by side), and `active` [ceil(B / n_tile), nblk] uint8,
    1 where some query of the n_tile-wide query tile selected the block."""
    b, nb_sel = top_blocks.shape
    dev = top_blocks.device
    queries = torch.arange(b, device=dev)[:, None].expand(b, nb_sel)
    slots = torch.full((nblk, b), -1, dtype=torch.int32, device=dev)
    slots[top_blocks, queries] = torch.arange(
        nb_sel, dtype=torch.int32, device=dev).expand(b, nb_sel)
    active = torch.zeros((-(-b // n_tile), nblk), dtype=torch.uint8,
                         device=dev)
    active[queries // n_tile, top_blocks] = 1
    return slots, active


@perf_model.register_op("kernel.blockmax_stage2_rescore")
def blockmax_stage2_rescore(
    qb: torch.Tensor,          # [B, d] bf16
    approx8: torch.Tensor,     # [N_pad, d] int8
    scale: torch.Tensor,       # [N_pad] f32
    vsq: torch.Tensor,         # [N_pad] f32
    valid: torch.Tensor,       # [N_pad] bool
    qsq: torch.Tensor,         # [B] f32
    top_blocks: torch.Tensor,  # [B, nb_sel] int64, distinct per query
    l2: bool,
) -> torch.Tensor:
    """The stage-2 kernel: [B, nb_sel * 512] f32, entry (q, i*512 + o) the
    f32 score of row o of block top_blocks[q, i] (-inf where masked), the
    plain version's layout. CUDA tensors only; one launch a call."""
    _check_scan_inputs(qb, approx8, scale, vsq, valid, qsq)
    if qb.device.type != "cuda":
        raise ValueError(f"the stage-2 kernel needs a CUDA tensor, got "
                         f"{qb.device}")
    b, d = qb.shape
    nblk = approx8.shape[0] // BLOCK
    if top_blocks.device != qb.device or top_blocks.ndim != 2 \
            or top_blocks.shape[0] != b:
        raise ValueError(f"top_blocks must be [{b}, nb_sel] on {qb.device}")
    nb_sel = top_blocks.shape[1]
    n_tile = query_tile(b, d)
    slots, active = stage2_maps(top_blocks, nblk, n_tile)
    lib = LIBRARY.load()
    out = torch.empty((b, nb_sel * BLOCK), dtype=torch.float32,
                      device=qb.device)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream(qb.device).cuda_stream
        err = lib.vt_blockmax_stage2(
            qb.data_ptr(), approx8.data_ptr(), scale.data_ptr(),
            vsq.data_ptr(), valid.data_ptr(), qsq.data_ptr(),
            slots.data_ptr(), active.data_ptr(), out.data_ptr(),
            b, d, nblk, nb_sel, int(bool(l2)), n_tile, stream,
        )
    if err != 0:
        raise RuntimeError(f"blockmax stage-2 kernel launch failed: "
                           f"cudaError {err}")
    count_launch(blockmax_stage2_rescore)
    ivf_ops.span_attrs(lambda: {
        "query_tile": n_tile,
        "mirror_bytes": stage2_mirror_bytes(active, d)})
    return out


#: kernel launches since the counter was last set to 0
blockmax_stage2_rescore.launches = 0


def stage2_topk(scores: torch.Tensor, top_blocks: torch.Tensor,
                rr: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-`rr` of the re-scored rows [B, nb_sel * 512] (lower position
    first on ties), sorted STAGE2_SORT_ELEMS scores at a time, with each
    position's row id: block top_blocks[q, pos // 512], row pos % 512 of
    it; -1 where the score is not finite."""
    b, s = scores.shape
    top_s = torch.empty((b, rr), dtype=scores.dtype, device=scores.device)
    pos = torch.empty((b, rr), dtype=torch.int64, device=scores.device)
    rows = max(1, STAGE2_SORT_ELEMS // s)
    for lo in range(0, b, rows):
        # copied out, so each sort's [rows, S] buffers free before the next
        top_s[lo:lo + rows], pos[lo:lo + rows] = stable_topk(
            scores[lo:lo + rows], rr)
    ids = (torch.gather(top_blocks, 1, pos // BLOCK) * BLOCK
           + pos % BLOCK).to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), ids,
                              torch.full_like(ids, -1))


def blockmax_stage2(
    queries: torch.Tensor,  # [B, d] f32
    approx8: torch.Tensor,
    scale: torch.Tensor,
    vsq: torch.Tensor,
    valid: torch.Tensor,
    bmax: torch.Tensor,     # [B, nblk] stage-1 block maxima
    nb_sel: int,
    rr: int,
    l2: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top `nb_sel` blocks per query (lower block first on ties), their
    rows re-scored at f32, top-`rr`. Returns ([B, rr] f32 scores, [B, rr]
    int32 ids; -1 where the score is not finite). CPU tensors take the
    plain version; CUDA tensors launch the re-score kernel once."""
    if queries.device.type == "cpu":
        return blockmax_stage2_reference(queries, approx8, scale, vsq,
                                         valid, bmax, nb_sel, rr, l2)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    _, top_blocks = stable_topk(bmax, nb_sel)  # [B, nb_sel]
    scores = blockmax_stage2_rescore(
        queries.to(torch.bfloat16).contiguous(), approx8, scale, vsq, valid,
        sqnorms(queries).contiguous(), top_blocks, l2)
    return stage2_topk(scores, top_blocks, rr)


def int8_blockmax_scan(
    queries: torch.Tensor,  # [B, d] f32
    approx8: torch.Tensor,  # [N_pad, d] int8, N_pad % 512 == 0
    scale: torch.Tensor,    # [N_pad] f32
    vsq: torch.Tensor,      # [N_pad] f32
    valid: torch.Tensor,    # [N_pad] bool
    r: int,
    l2: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused block-max int8 scan + top-r candidates: the semantics of the
    reference's Pallas entry point (r_eff = min(r, N_pad), 2x+8 block
    over-selection, no minimum-block gate). Returns ([B, r] scores,
    [B, r] int32 ids; -1 for masked)."""
    n_pad = approx8.shape[0]
    if n_pad % BLOCK:
        raise ValueError(f"N_pad={n_pad} must be a multiple of {BLOCK}")
    nblk = n_pad // BLOCK
    queries = queries.float()
    with ivf_ops.span("scan.blockmax", device=True):
        bmax = int8_blockmax_stage1(
            queries.to(torch.bfloat16).contiguous(), approx8, scale, vsq,
            valid, sqnorms(queries).contiguous(), l2)
    r_eff = min(r, n_pad)
    nb_sel = min(2 * max(32, r_eff // 4) + 8, nblk)
    rr = min(r_eff, nb_sel * BLOCK)
    with ivf_ops.span("scan.refine", device=True):
        return blockmax_stage2(queries, approx8, scale, vsq, valid, bmax,
                               nb_sel, rr, l2)


# The span API's home, ops/ivf.py, imports this module's kernels at its
# top, so it is bound here, after every name it imports from this module.
from vearch_tpu_torch.ops import ivf as ivf_ops  # noqa: E402
