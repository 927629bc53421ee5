#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (vearch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
1. Device and build: the card's name and power limit (nvidia-smi), then
   every hand-written kernel built from csrc/ with nvcc, one nvcc per
   source, and the host HNSW graph with g++, all started together;
   nvcc's -Xptxas -v report (registers, shared memory, spills) and the
   count of tensor-core instructions (HGMMA, HMMA) in each library's
   SASS, where cuobjdump is present. Then the data (1M x 128 rows from
   seed 0), and the HNSW graphs of phases 5 and 6 start building, each
   on its own thread.
2. Kernels vs their plain versions on the card, case by case, with
   kernel / plain / library times and the card's bound for the same work:
   - block-max scan: block maxima within one bf16 ulp of the plain
     PyTorch version, candidate ids equal except where explained (f32
     score ties, or a block whose selection flipped at the bf16 rounding
     boundary);
   - probe dots: every dot within 2*d f32 ulps of the sum of the
     absolute products (the bound on two summation orders of d exact
     products), zeros for padded probe slots and ids >= nlist, and
     exact zeros past each bucket's live length, also where the bytes
     there are not zero (probe_lens_cases);
   - block-max maxima of the kernel and the plain version against exact
     float64 ones on a random 1,000,448 x 128 mirror, for queries near
     mirror rows and at the main path's noise (phase_blockmax_exact).
3. Main path (bench.py's headline workload): 1M x 128 rows from seed 0,
   IVFPQ (2048 centroids, 32 subvectors, bf16 store), Engine.upsert in
   100k batches -> build_index, then on that one engine:
   - the full-scan regime: search (B=1024, k=10, rerank 128 and 512);
     recall@10 against exact f32 search on the card must be >= 0.95 at
     rerank 512 and the block-max kernel must have launched;
   - the probe regime (scan_mode "probe", nprobe 64, rerank 128 and
     512): recall@10 >= 0.95 at rerank 512, the probe-dots kernel must
     have launched, the dispatch tags must be probe_scan then rerank;
   - after deleting 1% of the docs no deleted key may come back on
     either path.
   Each kernel's launch count is set to 0 just before its path runs and
   read just after. The main-path kernel shapes (B=64 and B=1024, with
   the index's real mirror, buckets and probes) are then compared as in
   phase 2; the probe kernel's time is split into its pair grouping, the
   kernel alone, its zero-writing path and an output memset.
4. The rest of the engine (`phase_engine`), on a fresh engine of the
   main path's rows, index and width with two scalar fields from a
   seeded generator (`cat` int in [0, 100) with an INVERTED index, `tag`
   one of t0..t7 with a BITMAP index, a composite index on (tag, cat)),
   1% deleted:
   - three filters (`cat < 10`, `tag = t3`, both) through the full scan
     at rerank 512 (block-max kernel) and the probe regime at nprobe 64
     (probe dots): the scalar-index mask byte-equal to the column scan's,
     no returned id deleted or failing its filter, `brute_force` equal to
     an exact filtered f32 oracle on the card (ties aside); recall@10 of
     each path against that oracle, and each search's ms;
   - dump to a temporary directory, `Engine.open` (cuda by default) and
     `build_index` (absorb only): doc_count, `get` on 100 keys, a `query`
     page and the ids of the bench, gated, probe and six filtered
     requests equal before and after; dump, open (split by part) and
     absorb seconds, MB written, the first search after opening;
   - eight threads submit one 128-query request each at the same moment
     through the batch scheduler: results bit-identical to the same
     requests served one at a time through `_search_direct`; wall ms and
     block-max launches both ways, the scheduler's stats;
   - `warmup([64, 1024])`, `apply_config({"micro_batch": False})`,
     `close()`: a search still serves, directly, and no scheduler thread
     is left.
5. The rest of the index family (`phase_family`), each engine freed
   before the next, each path's launches set to 0 just before it:
   IVFRABITQ (three-stage at rerank 256 and r0 1024 / r1 256, which must
   launch no block-max kernel and reach the int8-only chain's recall
   less 0.01; stage0 "off", which must launch it; a profile split by
   stage), SCANN on inner product (full scan: block-max; probe: probe
   dots) and HNSW's scan (block-max) on the main path's rows; IVFPQ with
   the HNSW coarse quantizer (probe dots), BINARYIVF on random bits (each
   query finds itself at Hamming 0) and HNSW's graph at the sizes in
   REDUCED. No deleted key may come back on IVFRABITQ and the HNSW scan.
6. Disk and tiered storage (`phase_disk`), on the main path's rows in a
   temporary data_dir on local disk (removed after), each engine freed
   before the next:
   - DISKANN (2048 cells, nprobe 64, f32 Disk store) through Engine at a
     resident cache budget (4096 MB: every slab fits) and the default
     512 MB (~468 slots: the 1024-query batch takes several passes):
     first and warmed ms, H2D bytes a search from the PCIe ledger (a
     warmed resident search must move 0), recall@10 at the default
     rerank and at 512 (>= 0.95), probe-dots launches (> 0), one
     search split by part and one profiled, `tiering_info`; the
     probe-dots kernel at this path's shape (the resident pool as
     buckets) against its plain version, as in phase 2;
   - bench.py's tiered_storage_bench mix at these rows: 32 fixed
     8-query groups drawn Zipf(1.1) with seed 11, 12 x 32 warm and 8 x
     32 measured searches on the tiered budget, then the resident one;
   - 2048 tail rows far from every query, `Engine.dump` in place,
     `Engine.open`: dump and open seconds (segments, the rebuild of the
     bucket lists from assign.i32, the tail absorb), the first search,
     and its ids equal to the resident search's before the dump;
   - IVFPQ (the main path's settings, bf16 Disk store; block-max kernel,
     recall >= 0.95 at rerank 512, no fused rerank), IVFRABITQ
     (binary_refine_scan, counted as a disk search) and FLAT (the
     streaming exact scan, 64 queries, exact ids) on Disk stores, and
     HNSW "auto" on a Disk store at 20,000 rows (the graph, built on a
     second background thread from the start).

7. Runtime truth (`phase_runtime`):
   - footprint models against the card's allocator: a DeviceSampler
     (obs/sampler.py) whose model is an engine's summed
     `device_footprint_bytes`, its baseline taken with the card emptied
     before the engine exists, sampled after build and warmup with the
     card synchronised. Measured for the main path's IVFPQ (f32 store;
     full scan, then with the probe buckets published) and FLAT here,
     and, so that no 1M-row engine is built twice, for IVFRABITQ, SCANN
     and HNSW's scan in their phase_family runs and for DISKANN at the
     resident budget in phase_disk, and for the int4 IVFPQ in phase 8.
     Model, allocated, reserved, drift bytes and drift for each; drift
     must be false for every one (the sampler's tolerance, 64 MB + 0.5 x
     model), and allocated - baseline - model must lie in
     [0, UNMODELLED_BOUND_BYTES] for every one (both sides: a model that
     over-counts fails too);
   - the flight recorder (installed before the kernels build): the
     compile events of the engine's build and warmup, then 20 searches
     through Engine.search at B=1024 and B=1000 (padded to 1024), which
     must record none; the pad counters against perf_model's model;
     what the tracking costs a B=1 and a B=8 search (its tracked calls'
     shape signatures and lookups, timed on the host, beside the
     search's wall time);
   - accounting: eight concurrent 128-query callers in two spaces
     through the scheduler; per-space device_us, queue_wait_us and
     dispatches; the device_us sum within 10% of the runs' summed wall
     time; every request's trace["dispatches"] on its documented path;
   - quality: a QualityMonitor sampling every row of 16 searches (sample
     rate 1, no decay), its shadow brute_force searches on the card; its
     recall@10 estimate's Wilson bounds must hold this script's own
     recall@10 of the same rows; the health snapshot with recon_error.
8. Storage modes (`phase_storage_modes`), the main path's settings:
   IVFPQ with an int4 mirror (full scan; search ms and recall@10 at
   rerank 128 and 512, >= 0.95 at 512; the mirror's payload half of
   int8's; the peak allocated bytes of one search beside
   perf_model.scan_peak_bytes; a profile split by INT4_RANGES; TF32 off),
   IVFPQ with OPQ (build seconds and reconstruction error with and
   without it; full scan at rerank 512 through the block-max kernel,
   probe regime at nprobe 64 through the probe-dots kernel, recall@10
   >= 0.95 in both), IVFRABITQ with an int4 stage-1 tier (three-stage,
   rerank 256, recall@10 >= 0.95).
9. The cluster plane (`phase_cluster`): first one Engine of the main
   path's first CLUSTER_ROWS rows, index and width with an INVERTED `cat`
   field (the yardstick), then `StandaloneCluster(n_ps=3)` with no device
   argument (every partition server's engines on the card) driven
   through the port's SDK: a space of 2 partitions x 3 replicas, the
   rows upserted through the router in 5,000-doc requests (doc counts
   equal on every replica, summing to the rows), every replica built
   (the leaders through the router's /index/forcemerge, the followers
   one at a time through /ps/index/build); B=1024 searches through the
   router (a warm-up, then the median of 3): the full scan at rerank 512
   (topk_mode "blockmax", REDUCED) with recall@10 >= 0.95 against exact
   f32, at rerank 128, the probe regime at nprobe 64, a filtered search
   (cat < 10) against the exact filtered oracle; 60 B=1 searches (p50,
   p99); one profiled search (router, partition servers, engines); the
   device samplers; gated searches while a second client re-upserts
   CLUSTER_WRITES docs; then the partition server leading partition 0
   stops, a new leader must be named within 120 s, and the gated search
   must keep recall@10 >= 0.95 (ids before and after compared). Each
   path's launches are set to 0 just before it and read just after; the
   full scans must launch the block-max kernel and the probe path the
   probe-dots kernel. The cluster stops and the card is emptied before
   the footprint table.

Before the last three lines comes each kernel's time before its redesign,
quoted from PERF.md and labelled so. The last three lines are the card's
name and power limit, a JSON object with per-kernel numbers measured in
this run (and each bound computed from its inputs), and the JSON status
line. Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from vearch_tpu_torch.ops import perf_model

# the card's published peaks (perf_model's table): dense bf16 tensor-core
# operations and HBM3 bandwidth of an H100 SXM
PEAK_BF16_FLOPS = perf_model.PEAK_OPS[perf_model.DEFAULT_CHIP]["bf16"]
PEAK_BYTES = perf_model.PEAK_BYTES_PER_S[perf_model.DEFAULT_CHIP]
SCORE_TOL = (1e-5, 1e-4)  # (rtol, atol) for "tied" f32 candidate scores
BENCH_PARAMS = {"rerank": 128}  # bench.py's search request
GATED_PARAMS = {"rerank": 512}  # the depth the recall gate is held at
PROBE_PARAMS = {"scan_mode": "probe", "nprobe": 64}  # per_index.py's nprobe
F32_U = 2.0 ** -24  # unit roundoff of f32
GRAPH_ROWS, GRAPH_B = 20_000, 64  # HNSW graph mode (host build), reduced
HNSWQ_ROWS = 200_000  # IVFPQ + HNSW coarse quantizer (per_index.py's n)
FLAT_DISK_B = 64  # queries of the streaming FLAT scan on a disk store
CLUSTER_ROWS = 200_000  # rows served by phase_cluster, reduced
# phase_family's and phase_disk's cuts of scale, each with its reason
REDUCED = {
    "hnsw_graph": f"{GRAPH_ROWS} rows, {GRAPH_B} queries: the graph is "
                  "single-threaded host C++ whose 1M-row build would take "
                  "most of the run's time limit",
    "ivfpq_hnsw_quantizer": f"{HNSWQ_ROWS} rows and 1024 centroids "
                            "(scripts/benchmarks/per_index.py's scale): "
                            "absorb assigns every row by a host graph walk",
    "flat_disk": f"{FLAT_DISK_B} queries: the exact scan streams all 1M "
                 "rows through the card in 262,144-row chunks per batch",
    "hnsw_disk": f"{GRAPH_ROWS} rows, {GRAPH_B} queries, as hnsw_graph: "
                 "the graph that auto picks on a disk store is the same "
                 "single-threaded host build",
    "cluster": f"{CLUSTER_ROWS} rows (the main path's first), 2 "
               "partitions x 3 replicas: every doc crosses the router and the "
               "raft log of 3 replicas as JSON on one Python process "
               "(824-1259 docs/s on the chip machine's hosts), so a 1M-row "
               "ingest does not fit the run's time limit. Its rerank-512 "
               "full scans name topk_mode 'blockmax': at 100k rows a "
               "partition the 'auto' gate (blocks >= 4 x max(32, rerank / "
               "4)) would select exactly, where the main path's 1M rows "
               "select by block maxima",
}
# each kernel's B=1024 time before its redesign, quoted from PERF.md
# section 6 (not measured by this script): the CUDA-core block-max
# kernel and the one-block-per-pair probe kernel, on an H100 SXM at 700 W
QUOTED_PREVIOUS_MS = {"int8_blockmax_scan": 10.39, "ivf_probe_dots": 25.36}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def build_data(n=1_000_000, d=128, seed=0):
    """bench.py's data: 5000 gaussian clusters, 1024 perturbed queries."""
    rng = np.random.default_rng(seed)
    nc = 5000
    centers = (rng.standard_normal((nc, d)) * 3).astype(np.float32)
    which = rng.integers(0, nc, n)
    base = centers[which] + 0.7 * rng.standard_normal((n, d)).astype(
        np.float32)
    q_idx = rng.choice(n, 1024, replace=False)
    queries = base[q_idx] + 0.1 * rng.standard_normal((1024, d)).astype(
        np.float32)
    return base, queries


def mirror_case(n, d, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    scale = np.maximum(np.abs(base).max(axis=1) / 127.0, 1e-12)
    q8 = np.clip(np.rint(base / scale[:, None]), -127, 127).astype(np.int8)
    deq = q8.astype(np.float32) * scale[:, None]
    vsq = np.sum(deq * deq, axis=1).astype(np.float32)
    return base, q8, scale.astype(np.float32), vsq


def small_cases():
    """The cases of tests/test_torch_blockmax.py (name, arrays, r, l2)."""
    out = []
    base, q8, sc, vs = mirror_case(4096, 64, 9)
    q = np.random.default_rng(1).standard_normal((7, 64)).astype(np.float32)
    out.append(("l2", q, q8, sc, vs, np.ones(4096, bool), 64, True))
    out.append(("ip", q, q8, sc, vs, np.ones(4096, bool), 64, False))
    q = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    strided = np.ones(4096, bool)
    strided[::3] = False
    out.append(("mask_strided", q, q8, sc, vs, strided, 32, True))
    out.append(("mask_all_false", q, q8, sc, vs, np.zeros(4096, bool), 8,
                True))
    base, q8, sc, vs = mirror_case(2560, 64, 4)
    rng = np.random.default_rng(6)
    q = base[rng.choice(2560, 6, replace=False)] + 0.01
    out.append(("rows2560", q, q8, sc, vs, np.ones(2560, bool), 32, True))
    base, q8, sc, vs = mirror_case(2048, 100, 17)
    rng = np.random.default_rng(18)
    q = base[rng.choice(2048, 5, replace=False)] + 0.01
    out.append(("d100", q, q8, sc, vs, np.ones(2048, bool), 16, True))
    base, q8, sc, vs = mirror_case(4096, 64, 19)
    q = np.random.default_rng(20).standard_normal((70, 64)).astype(np.float32)
    out.append(("b70", q, q8, sc, vs, np.ones(4096, bool), 48, True))
    base, q8, sc, vs = mirror_case(79 * 512, 16, 12)
    rng = np.random.default_rng(13)
    q = base[rng.choice(79 * 512, 3, replace=False)] + 0.01
    out.append(("prune79", q, q8, sc, vs, np.ones(79 * 512, bool), 8, True))
    # the kernel's narrow query tile (B <= 8) and its byte-load path
    base, q8, sc, vs = mirror_case(2048, 30, 21)
    q = base[np.random.default_rng(22).choice(2048, 1, replace=False)] + 0.01
    out.append(("b1_d30", q, q8, sc, vs, np.ones(2048, bool), 16, True))
    base, q8, sc, vs = mirror_case(4096, 16, 23)
    q = np.random.default_rng(24).standard_normal((8, 16)).astype(np.float32)
    out.append(("b8_d16_ip", q, q8, sc, vs, np.ones(4096, bool), 16, False))
    # three query tiles whose CTAs each walk several row blocks
    base, q8, sc, vs = mirror_case(600 * 512, 64, 25)
    rng = np.random.default_rng(26)
    q = base[rng.choice(600 * 512, 300, replace=False)] + 0.01
    va = rng.random(600 * 512) > 0.1
    out.append(("b300_walk", q, q8, sc, vs, va, 64, True))
    return out


def bf16_ulp(x):
    import torch

    mag = torch.clamp(x.abs(), min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def median_ms(fn, reps=10, warm=2):
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare_case(name, q, a8, sc, vs, va, r, l2, timing=True):
    """Kernel vs plain stage 1 (and the candidates each selects) on the
    card. Returns a result dict; raises on disagreement."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms, stable_topk

    qb = q.to(torch.bfloat16).contiguous()
    qsq = sqnorms(q).contiguous()
    n_pad, d = a8.shape
    b = q.shape[0]
    nblk = n_pad // bms.BLOCK
    args = (qb, a8, sc, vs, va, qsq, l2)
    bk = bms.int8_blockmax_stage1(*args)
    bp = bms.int8_blockmax_stage1_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(torch.isinf(bk), torch.isinf(bp)),
          f"{name}: -inf pattern differs")
    fin = torch.isfinite(bp)
    err = (bk[fin] - bp[fin]).abs()
    ulp = bf16_ulp(bp[fin])
    check(bool((err <= ulp).all()), f"{name}: bmax beyond one bf16 ulp")
    max_abs = float(err.max()) if err.numel() else 0.0
    n_off = int((err > 0).sum())
    # candidates through the same stage 2 from each stage 1
    r_eff = min(r, n_pad)
    nb_sel = min(2 * max(32, r_eff // 4) + 8, nblk)
    rr = min(r_eff, nb_sel * bms.BLOCK)
    qf = q.float()
    sk, ik = bms.blockmax_stage2(qf, a8, sc, vs, va, bk, nb_sel, rr, l2)
    sp, ip = bms.blockmax_stage2(qf, a8, sc, vs, va, bp, nb_sel, rr, l2)
    diff = ik != ip
    tie = diff & (torch.isclose(sk, sp, rtol=SCORE_TOL[0],
                                atol=SCORE_TOL[1]))
    # a query whose selected block set differs only by blocks at the bf16
    # rounding boundary of the nb_sel-th block maximum
    selk = stable_topk(bk, nb_sel)[1]
    selp = stable_topk(bp, nb_sel)[1]
    tk = bk.gather(1, selk[:, -1:])
    tp = bp.gather(1, selp[:, -1:])
    boundary = torch.zeros(b, dtype=torch.bool, device=q.device)
    for i in range(b):
        a_set = set(selk[i].tolist())
        p_set = set(selp[i].tolist())
        if a_set == p_set:
            continue
        flip = torch.tensor(sorted(a_set ^ p_set), device=q.device)
        near_k = (bk[i, flip] - tk[i]).abs() <= bf16_ulp(tk[i])
        near_p = (bp[i, flip] - tp[i]).abs() <= bf16_ulp(tp[i])
        boundary[i] = bool((near_k & near_p).all())
    explained = tie | (diff & boundary[:, None])
    unexplained = int((diff & ~explained).sum())
    res = {
        "case": name, "B": b, "N_pad": n_pad, "d": d, "r": r, "l2": l2,
        "bmax_max_abs_err": max_abs, "bmax_entries_off_by_1ulp": n_off,
        "id_mismatches": int(diff.sum()), "explained_by_score_tie":
        int(tie.sum()), "explained_by_boundary_selection":
        int((diff & ~tie & boundary[:, None]).sum()),
        "unexplained_mismatches": unexplained,
    }
    check(unexplained == 0, f"{name}: {unexplained} unexplained id "
          f"mismatches")
    if timing:
        res["kernel_ms"] = median_ms(lambda: bms.int8_blockmax_stage1(*args))
        res["plain_ms"] = median_ms(
            lambda: bms.int8_blockmax_stage1_reference(*args))
        a8b = a8.to(torch.bfloat16)
        res["library_ms"] = median_ms(
            lambda: torch.matmul(qb, a8b.T).view(b, nblk, bms.BLOCK)
            .amax(-1))
        del a8b
        flops = 2.0 * b * n_pad * d
        nbytes = (b * d * 2 + n_pad * d + n_pad * 4 * 2 + n_pad
                  + b * 4 + b * nblk * 4)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        res["bound_ms"] = max(t_ops, t_bytes)
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    print("kernel_case " + json.dumps(res), flush=True)
    return res


def phase_kernels(dev):
    import torch

    out = []
    for name, q, q8, sc, vs, va, r, l2 in small_cases():
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (q.astype(np.float32), q8, sc, vs, va)]
        out.append(compare_case(name, *t, r, l2))
    return out


def bucket_case(nlist, cap, d, b, nprobe, seed):
    """Random int8 buckets, queries and probe table (int32)."""
    rng = np.random.default_rng(seed)
    buckets = rng.integers(-127, 128, (nlist, cap, d)).astype(np.int8)
    q = rng.standard_normal((b, d)).astype(np.float32)
    probes = rng.integers(0, nlist, (b, nprobe)).astype(np.int32)
    return q, probes, buckets


def probe_cases():
    """The probe-dots cases of tests/test_torch_probe.py, plus B=70 and
    d=100 together: (name, queries, probes, buckets)."""
    out = [("b4", *bucket_case(16, 128, 32, 4, 4, 31)),
           ("d100", *bucket_case(16, 128, 100, 8, 8, 32)),
           ("d30_bytes", *bucket_case(16, 128, 30, 8, 8, 33)),
           ("cap130", *bucket_case(5, 130, 64, 3, 5, 34)),
           ("b70_d100", *bucket_case(16, 256, 100, 70, 8, 35))]
    q, probes, buckets = bucket_case(16, 128, 64, 1, 16, 36)
    probes[0] = np.random.default_rng(37).permutation(16)  # nprobe = nlist
    out.append(("all_cells_b1", q, probes, buckets))
    q, probes, buckets = bucket_case(16, 128, 64, 6, 8, 38)
    probes[:, -3:] = -1  # padded probe slots give zeros
    probes[0, :] = -1
    out.append(("pad_slots", q, probes, buckets))
    return out


def probe_lens_cases():
    """Probe-dots cases with per-bucket live lengths: (name, queries,
    probes, buckets, lens). Rows past a bucket's length are zero bytes,
    as the index publishes them, except in "poisoned", whose tails hold
    random bytes that must never reach the output."""
    def ragged(nlist, cap, d, b, nprobe, seed, lens, poison=False):
        q, probes, buckets = bucket_case(nlist, cap, d, b, nprobe, seed)
        lens = np.asarray(lens, np.int32)
        if not poison:
            buckets[np.arange(cap)[None, :] >= lens[:, None]] = 0
        return q, probes, buckets, lens

    lens8 = [0, 1, 127, 130, 256, 64, 200, 3]
    out = [("ragged", *ragged(8, 256, 64, 12, 8, 41, lens8)),
           ("poisoned", *ragged(8, 256, 64, 12, 8, 42, lens8, poison=True)),
           ("ragged_d30", *ragged(8, 256, 30, 9, 4, 43, lens8)),
           ("ragged_d100_b1", *ragged(8, 256, 100, 1, 8, 44, lens8))]
    q, probes, buckets, lens = ragged(8, 256, 64, 70, 2, 45, lens8)
    probes[:] = 3  # every query probes one bucket, twice
    out.append(("one_bucket_b70", q, probes, buckets, lens))
    lens16 = np.random.default_rng(46).integers(0, 129, 16)
    lens16[:2] = (0, 128)
    q, probes, buckets, lens = ragged(16, 128, 64, 3, 16, 47, lens16)
    probes[:] = np.random.default_rng(48).permutation(16)  # nprobe = nlist
    out.append(("all_cells_ragged", q, probes, buckets, lens))
    rng = np.random.default_rng(50)
    lens32 = rng.integers(0, 385, 32)
    lens32[:3] = (384, 0, 1)
    q, probes, buckets, lens = ragged(32, 384, 64, 70, 8, 51, lens32)
    zipf = 1.0 / np.arange(1, 33)  # a skewed probe table: bucket 0 hot
    probes[:] = rng.choice(32, probes.shape, p=zipf / zipf.sum())
    out.append(("skewed_b70", q, probes, buckets, lens))
    q, probes, buckets, lens = ragged(8, 256, 64, 6, 8, 49, lens8,
                                      poison=True)
    probes[:, -2] = -1      # padded probe slots
    probes[1, 0] = 8        # ids >= nlist (the card only: the CPU raises)
    probes[4, 3] = 2 ** 31 - 1
    out.append(("bad_ids_poisoned", q, probes, buckets, lens))
    return out


def probe_tolerance(qb, probes, buckets, lens=None):
    """Per-entry bound on |kernel - plain|: both sum the same d exact
    products (bf16 x int8 is exact in f32) in other orders, and each
    order is within (d-1) u sum|terms| of the exact sum (0 past lens)."""
    from vearch_tpu_torch.ops.probe_dots import ivf_probe_dots_reference

    d = qb.shape[1]
    mag = ivf_probe_dots_reference(qb.abs(), probes, buckets.abs(), lens)
    return 2.0 * d * F32_U * mag, mag


def compare_probe_case(name, q, probes, buckets, lens=None, timing=True,
                       breakdown=False):
    """Probe-dots kernel vs its plain version on the card. Returns a
    result dict; raises on disagreement. Ids >= nlist go to the plain
    version as padded slots (-1): the kernel writes zeros for both.
    `breakdown` also times the kernel alone on pre-grouped pairs, its
    zero-writing path alone (every length 0, the same output) and a
    memset of an output of the same size."""
    import torch

    from vearch_tpu_torch.ops import probe_dots as pd

    qb = q.to(torch.bfloat16).contiguous()
    b, d = qb.shape
    nprobe = probes.shape[1]
    nlist, cap, _ = buckets.shape
    plain_probes = torch.where(probes < nlist, probes,
                               torch.full_like(probes, -1))
    got = pd.ivf_probe_dots(qb, probes, buckets, lens)
    want = pd.ivf_probe_dots_reference(qb, plain_probes, buckets, lens)
    torch.cuda.synchronize()
    tol, mag = probe_tolerance(qb, plain_probes, buckets, lens)
    err = (got - want).abs()
    check(bool((err <= tol).all()), f"{name}: probe dots beyond 2d ulps")
    pad = (plain_probes < 0)[:, :, None].expand_as(got)
    check(bool((got[pad] == 0).all()), f"{name}: padded slot not zero")
    res = {"case": name, "B": b, "nprobe": nprobe, "nlist": nlist,
           "cap": cap, "d": d}
    pc = torch.clamp(plain_probes, min=0).long()
    if lens is not None:
        past = torch.arange(cap, device=q.device) >= lens[pc][:, :, None]
        check(bool((got[past] == 0).all()),
              f"{name}: a row past its bucket's length is not zero")
        res["entries_past_lens"] = int(past.sum())
    ulps = err / torch.clamp(mag * F32_U, min=torch.finfo(torch.float32).tiny)
    res.update(max_abs_err=float(err.max()),
               max_err_in_u_sum_abs=float(ulps.max()),
               entries_off=int((err > 0).sum()))
    if timing:
        res["kernel_ms"] = median_ms(
            lambda: pd.ivf_probe_dots(qb, probes, buckets, lens))
        # the wrapper's share of it: the pair sort and segment offsets
        res["grouping_ms"] = median_ms(lambda: pd.group_pairs(probes, nlist))
        if breakdown:
            order, offs = pd.group_pairs(probes, nlist)
            full = lens if lens is not None else torch.full(
                (nlist,), cap, dtype=torch.int32, device=q.device)
            res["kernel_only_ms"] = median_ms(lambda: pd.launch_grouped(
                qb, order, offs, full, buckets, nprobe))
            zero = torch.zeros_like(full)
            res["zero_lengths_ms"] = median_ms(lambda: pd.launch_grouped(
                qb, order, offs, zero, buckets, nprobe))
            out = torch.empty_like(got)
            res["output_memset_ms"] = median_ms(lambda: out.zero_())
            del out
        res["plain_ms"] = median_ms(
            lambda: pd.ivf_probe_dots_reference(qb, plain_probes, buckets,
                                                lens))
        bb = buckets.to(torch.bfloat16)

        def library():
            # bf16 gather + one batched product per 32-query chunk
            for lo in range(0, b, pd.PLAIN_CHUNK):
                hi = min(lo + pd.PLAIN_CHUNK, b)
                vecs = bb[pc[lo:hi]].view(hi - lo, nprobe * cap, d)
                torch.bmm(vecs, qb[lo:hi, :, None])

        res["library_ms"] = median_ms(library)
        del bb
        res.update(probe_bound(qb, plain_probes, buckets, lens))
    print("probe_case " + json.dumps(res), flush=True)
    return res


def probe_bound(qb, probes, buckets, lens):
    """The least time for these inputs: the live rows of the distinct
    probed buckets read once, the queries, probes and lengths read once,
    the [B, nprobe, cap] f32 output written once; 2 * d operations per
    live row of each (query, probe) pair."""
    import torch

    b, d = qb.shape
    nprobe = probes.shape[1]
    nlist, cap, _ = buckets.shape
    if lens is None:
        lens = torch.full((nlist,), cap, dtype=torch.int32,
                          device=qb.device)
    ok = probes >= 0
    live = torch.where(ok, lens[torch.clamp(probes, min=0).long()], 0)
    uniq = torch.unique(probes[ok]).long()
    live_rows = int(lens[uniq].sum())
    flops = 2.0 * d * int(live.sum())
    pairs = int(ok.sum())
    nbytes = (b * d * 2 + b * nprobe * 4 + nlist * 4 + live_rows * d
              + b * nprobe * cap * 4)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"distinct_buckets": int(uniq.numel()),
            "live_rows_read": live_rows, "operations": flops,
            "live_rows_per_pair": flops / (2.0 * d * pairs) if pairs else 0.0,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_probe_kernels(dev):
    import torch

    out = []
    for name, q, probes, buckets in probe_cases():
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (q, probes, buckets)]
        out.append(compare_probe_case(name, *t))
    for name, *arrays in probe_lens_cases():
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in arrays]
        out.append(compare_probe_case(name, *t))
    return out


def phase_blockmax_exact(dev, nblk=1954, d=128, b=1024) -> dict:
    """Block maxima of the kernel and of the plain version against exact
    ones (float64 scores of the same bf16 queries and int8 rows) on a
    random nblk*512 x d mirror: for queries that nearly duplicate mirror
    rows (noise 0.01: L2 scores near 0, where |q|^2 + |v|^2 - 2 q.v
    cancels) and at the main path's noise (0.1). Distances are in bf16
    ulps of the plain maximum."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    base, q8, sc, vs = mirror_case(nblk * bms.BLOCK, d, 5)
    a8, sc_t, vs_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in (q8, sc, vs))
    valid = torch.ones(a8.shape[0], dtype=torch.bool, device=dev)
    a64 = a8.double()
    out = {}
    for name, noise in (("near_duplicate", 0.01), ("main_path_noise", 0.1)):
        rng = np.random.default_rng(7)
        qn = base[:b] + noise * rng.standard_normal((b, d)).astype(np.float32)
        q = torch.from_numpy(qn).to(dev)
        qb, qsq = q.to(torch.bfloat16).contiguous(), sqnorms(q).contiguous()
        args = (qb, a8, sc_t, vs_t, valid, qsq, True)
        bk = bms.int8_blockmax_stage1(*args)
        bp = bms.int8_blockmax_stage1_reference(*args)
        check(bool(torch.isfinite(bk).all() and torch.isfinite(bp).all()),
              f"blockmax_exact {name}: a maximum is not finite")
        exact = []
        for lo in range(0, b, 128):
            dots = qb[lo:lo + 128].double() @ a64.T * sc_t.double()[None]
            s = -(qsq[lo:lo + 128].double()[:, None] - 2 * dots
                  + vs_t.double()[None])
            exact.append(s.view(-1, nblk, bms.BLOCK).amax(-1))
        exact = torch.cat(exact)
        ulp = bf16_ulp(bp).double()
        kp = (bk - bp).abs().double() / ulp
        out[name] = {
            "kernel_vs_plain_max_ulps": float(kp.max()),
            "entries_beyond_1ulp": int((kp > 1).sum()),
            "entries_off": int((kp > 0).sum()), "entries": kp.numel(),
            "kernel_vs_exact_max_ulps": float(
                ((bk.double() - exact).abs() / ulp).max()),
            "plain_vs_exact_max_ulps": float(
                ((bp.double() - exact).abs() / ulp).max()),
            "smallest_abs_max": float(bp.abs().min())}
    print("blockmax_exact " + json.dumps(out), flush=True)
    # queries off the rows keep compare_case's one-ulp contract
    check(out["main_path_noise"]["entries_beyond_1ulp"] == 0,
          "blockmax_exact: a maximum beyond one bf16 ulp at noise 0.1")
    return out


def phase_main(dev, base, queries):
    """The port's main path through Engine; returns its numbers."""
    import torch

    from vearch_tpu_torch.engine.engine import Engine, SearchRequest
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema,
    )
    from vearch_tpu_torch.ops import ivf as ivf_ops

    (n, d), batch = base.shape, 1024
    params = {"ncentroids": 2048, "nsubvector": 32, "train_iters": 8,
              "training_threshold": 2 * n, "store_dtype": "bfloat16"}
    schema = TableSchema("bench", [FieldSchema(
        "emb", DataType.VECTOR, dimension=d,
        index=IndexParams("IVFPQ", MetricType.L2, params))])
    eng = Engine(schema)
    check(eng.device.type == "cuda", "engine did not default to cuda")
    t0 = time.monotonic()
    for i in range(0, n, 100_000):
        hi = min(i + 100_000, n)
        eng.upsert([{"_id": f"d{j}", "emb": base[j]} for j in range(i, hi)])
    ingest_s = time.monotonic() - t0
    t0 = time.monotonic()
    eng.build_index()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    print(f"main: ingest {ingest_s:.1f}s build {build_s:.1f}s", flush=True)

    # exact f32 oracle on the card (TF32 off), chunked over queries
    truth = exact_topk(dev, queries[:batch], base, MetricType.L2)

    def request(params):
        return SearchRequest(vectors={"emb": queries[:batch]}, k=10,
                             include_fields=[], raw_results=True,
                             index_params=params)

    def timed(params, iters=5):
        req = request(params)
        eng.search(req)  # warm-up (first call flushes the device mirrors)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(iters):
            res = eng.search(req)
        return res, (time.monotonic() - t0) / iters

    out = {"ingest_s": ingest_s, "build_s": build_s}
    index = eng.indexes["emb"]

    # -- full-scan regime ---------------------------------------------------
    reset_launches()
    # the JAX package's bench request (rerank 128); its recall is
    # reported, the block-max selection's cost at this depth
    res, sec = timed(BENCH_PARAMS)
    out["bench_rerank128"] = {"search_ms": sec * 1e3, "qps": batch / sec,
                              "recall_at_10": recall_at_10(res, truth)}
    # the same depth with exact top-k selection (no block maxima):
    # separates the selection's recall cost from the quantizer's
    res, sec = timed(dict(BENCH_PARAMS, topk_mode="exact"), iters=1)
    out["exact_topk_rerank128"] = {"search_ms": sec * 1e3,
                                   "recall_at_10": recall_at_10(res, truth)}
    # the gated request: rerank deep enough for the bench's 0.95 gate
    res, sec = timed(GATED_PARAMS)
    recall = recall_at_10(res, truth)
    out["gated"] = {"params": GATED_PARAMS, "search_ms": sec * 1e3,
                    "qps": batch / sec, "recall_at_10": recall}
    out["profile"] = profile_search(eng, request(GATED_PARAMS))
    out["launches"] = read_launches()
    print("main_search " + json.dumps(out), flush=True)
    check(recall >= 0.95, f"recall@10 {recall} < 0.95")
    check(out["launches"]["int8_blockmax_scan"] > 0,
          "full-scan path never launched the block-max kernel")
    top_hits = {row[0] for row in res.keys if row}

    # -- probe regime, same engine and index --------------------------------
    # the first probe search publishes the buckets; timed here on its own
    check(index._dirty, "buckets already published before the probe phase")
    t0 = time.monotonic()
    index._publish()
    torch.cuda.synchronize()
    pops = index.cell_populations()
    probe = {"publish_s": time.monotonic() - t0, "cap": index._cap,
             "mean_bucket_len": float(np.mean(pops)),
             "longest_bucket": int(max(pops)), "nlist": len(pops)}
    print("probe_publish " + json.dumps(probe), flush=True)
    reset_launches()
    for depth in (BENCH_PARAMS, GATED_PARAMS):
        params = dict(PROBE_PARAMS, **depth)
        res, sec = timed(params)
        probe[f"rerank{depth['rerank']}"] = {
            "params": params, "search_ms": sec * 1e3, "qps": batch / sec,
            "recall_at_10": recall_at_10(res, truth)}
    ledger: list = []
    ivf_ops.set_dispatch_ledger(ledger)
    try:
        eng.search(request(dict(PROBE_PARAMS, **GATED_PARAMS)))
    finally:
        ivf_ops.set_dispatch_ledger(None)
    probe["tags"] = ledger
    probe["profile"] = profile_search(
        eng, request(dict(PROBE_PARAMS, **GATED_PARAMS)))
    probe["launches"] = read_launches()
    print("probe_search " + json.dumps(probe), flush=True)
    recall = probe["rerank512"]["recall_at_10"]
    check(recall >= 0.95, f"probe recall@10 {recall} < 0.95")
    check(ledger == ["probe_scan", "rerank"], f"probe tags {ledger}")
    check(probe["launches"]["ivf_probe_dots"] > 0,
          "probe path never launched the probe-dots kernel")
    out["probe"] = probe
    top_hits |= {row[0] for row in res.keys if row}

    # -- deletes: 1% of the docs, including every query's top hit ------------
    rng = np.random.default_rng(1)
    gone = {f"d{j}" for j in rng.choice(n, n // 100, replace=False)}
    gone |= top_hits
    deleted = eng.delete(sorted(gone))
    check(deleted == len(gone), "delete count")
    for name, params in (("full", GATED_PARAMS),
                         ("probe", dict(PROBE_PARAMS, **GATED_PARAMS))):
        res2 = eng.search(request(params))
        leaked = sum(k in gone for row in res2.keys for k in row)
        print(f"main: deleted {deleted}, deleted keys returned on the "
              f"{name} path: {leaked}", flush=True)
        check(leaked == 0, f"{leaked} deleted keys came back ({name})")
        check(all(len(row) == 10 for row in res2.keys),
              f"short result rows ({name})")
    out["deleted"] = deleted
    mirror = index._mirror.flush()
    valid = torch.zeros(mirror[0].shape[0], dtype=torch.bool, device=dev)
    valid[:n] = eng._device_alive_mask(n)
    return out, truth, mirror, valid, index


def exact_topk(dev, queries, base, metric, k=10, valid=None):
    """Exact top-k row ids [B, k] on the card (f32, TF32 off), 128
    queries at a time; only rows where `valid` (bool [N]) is set, when
    given."""
    import torch

    from vearch_tpu_torch.ops.distance import similarity_scores

    base_d = torch.from_numpy(np.ascontiguousarray(base)).to(dev)
    base_sq = (base_d.float() ** 2).sum(1)
    q_d = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    mask = None if valid is None else torch.from_numpy(valid).to(dev)
    out = []
    for lo in range(0, q_d.shape[0], 128):
        s = similarity_scores(q_d[lo:lo + 128], base_d, metric, base_sq)
        if mask is not None:
            s = torch.where(mask[None, :], s, torch.full_like(s, -np.inf))
        out.append(torch.topk(s, k, dim=1).indices)
    return torch.cat(out).cpu().numpy()


def recall_at_10(res, truth) -> float:
    """Share of the exact top 10 among the returned keys ("d<row>")."""
    got = [[int(k[1:]) for k in row] for row in res.keys]
    return sum(len(set(g) & set(t.tolist()))
               for g, t in zip(got, truth)) / truth.size


def family_engine(index_type, metric, params, d=128):
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema,
    )

    schema = TableSchema("family", [FieldSchema(
        "emb", DataType.VECTOR, dimension=d,
        index=IndexParams(index_type, MetricType(metric), params))])
    return Engine(schema)


def ingest_and_build(eng, rows, step=100_000) -> dict:
    """Engine.upsert in `step`-row batches, then build_index; seconds."""
    import torch

    t0 = time.monotonic()
    for i in range(0, len(rows), step):
        eng.upsert([{"_id": f"d{j}", "emb": rows[j]}
                    for j in range(i, min(i + step, len(rows)))])
    ingest_s = time.monotonic() - t0
    t0 = time.monotonic()
    eng.build_index()
    torch.cuda.synchronize()
    return {"rows": len(rows), "ingest_s": ingest_s,
            "build_s": time.monotonic() - t0}


def family_request(queries, params):
    from vearch_tpu_torch.engine.engine import SearchRequest

    return SearchRequest(vectors={"emb": queries}, k=10, include_fields=[],
                         raw_results=True, index_params=params)


def run_path(eng, queries, params, truth, iters=3, recall=recall_at_10):
    """One search path: its kernel launches (counts set to 0 just before,
    read just after), its dispatch tags, recall@10 and wall ms per
    search (mean of `iters` after a warm-up)."""
    import torch

    from vearch_tpu_torch.ops import ivf as ivf_ops

    req = family_request(queries, params)
    reset_launches()
    ledger: list = []
    ivf_ops.set_dispatch_ledger(ledger)
    try:
        res = eng.search(req)
    finally:
        ivf_ops.set_dispatch_ledger(None)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(iters):
        eng.search(req)
    torch.cuda.synchronize()
    sec = (time.monotonic() - t0) / iters
    out = {"params": params, "B": len(queries), "search_ms": sec * 1e3,
           "qps": len(queries) / sec, "recall_at_10": recall(res, truth),
           "tags": ledger, "launches": read_launches()}
    print("family_path " + json.dumps(out), flush=True)
    return out, res


def check_deletes(eng, queries, res, paths, n, seed=2) -> int:
    """Delete 1% of the docs and every query's top hit; no deleted key
    may come back on any of `paths` (request params)."""
    rng = np.random.default_rng(seed)
    gone = {f"d{j}" for j in rng.choice(n, n // 100, replace=False)}
    gone |= {row[0] for row in res.keys if row}
    check(eng.delete(sorted(gone)) == len(gone), "family delete count")
    for params in paths:
        res2 = eng.search(family_request(queries, params))
        leaked = sum(k in gone for row in res2.keys for k in row)
        check(leaked == 0, f"{leaked} deleted keys came back ({params})")
        check(all(len(row) == 10 for row in res2.keys),
              f"short result rows ({params})")
    return len(gone)


def release_device_memory() -> None:
    """Collect what the last engine left and hand the cached blocks back
    to the card, so the next engine starts from an empty card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def family_rabitq(dev, base, queries, truth) -> dict:
    """IVFRABITQ, L2, full width: the three-stage chain at rerank 256
    (r0 the auto depth) and r0 1024 / r1 256, and stage0 "off" at rerank
    256."""
    from vearch_tpu_torch.ops import binary_scan as bs

    n, d = base.shape
    fp = Footprint()
    eng = family_engine("IVFRABITQ", "L2", {
        "ncentroids": 2048, "nprobe": 64, "train_iters": 8,
        "training_threshold": 2 * n, "store_dtype": "bfloat16"})
    out = ingest_and_build(eng, base)
    index = eng.indexes["emb"]
    eng.warmup([1024])
    out["footprint"] = fp.measure("IVFRABITQ", eng)
    rows0 = bs.refine_stage_rows()
    auto, res = run_path(eng, queries, {"rerank": 256}, truth)
    rows1 = bs.refine_stage_rows()
    deep, _ = run_path(eng, queries, {"r0": 1024, "r1": 256}, truth)
    off, _ = run_path(eng, queries, {"stage0": "off", "rerank": 256}, truth)
    out.update(three_stage_auto=auto, three_stage_r0_1024=deep,
               stage0_off=off, stage_rows_per_search={
                   s: (rows1[s] - rows0[s]) // 4 for s in rows0})
    for path in (auto, deep):
        check(path["tags"] == ["binary_refine_rerank"],
              f"three-stage tags {path['tags']}")
        check(path["launches"]["int8_blockmax_scan"] == 0,
              "the three-stage chain launched the block-max kernel")
    check(off["launches"]["int8_blockmax_scan"] > 0,
          "stage0 off never launched the block-max kernel")
    # the reference's acceptance gate (tests/test_index_family.py:115)
    check(deep["recall_at_10"] >= off["recall_at_10"] - 0.01,
          f"three-stage recall {deep['recall_at_10']} < int8-only "
          f"{off['recall_at_10']} - 0.01 at r0 1024 / r1 256")
    planes = index._bits.flush()[0]
    out["bytes"] = {"bit_plane_payload": n * planes.shape[1],
                    "int8_mirror_payload": n * d,
                    "bit_planes_device": index._bits.device_bytes(),
                    "int8_mirror_device": index._mirror.device_bytes()}
    # the depths a rerank-256 search runs at (the engine asks for k=16):
    # r0 is the auto depth of k, not of the requested rerank
    out["depths_rerank256"] = index._stage_depths(16, {"rerank": 256})
    prof = profile_search(eng, family_request(queries, {"rerank": 256}),
                          bs.STAGE_RANGES)
    stages = prof["ranges_ms"]
    stage0 = sum(stages[k] for k in bs.STAGE_RANGES[:4])
    prof["stage0_share"] = stage0 / max(sum(stages.values()), 1e-9)
    # the least time of stage 0's work: 2 B N d operations at the bf16
    # peak, against the planes read once (N d/8 bytes)
    prof["stage0_bound_ms"] = max(
        2.0 * len(queries) * planes.shape[0] * planes.shape[1] * 8
        / PEAK_BF16_FLOPS, planes.numel() / PEAK_BYTES) * 1e3
    out["profile"] = prof
    out["deleted"] = check_deletes(
        eng, queries, res, [{"rerank": 256},
                            {"stage0": "off", "rerank": 256}], n)
    return out


def family_scann(dev, base, queries) -> dict:
    """SCANN, inner product on the same rows: full scan and probe regime
    (nprobe 64) at rerank 128 and 512, build with the anisotropic
    training and encoding timed apart."""
    import torch

    from vearch_tpu_torch.engine.types import MetricType

    n, _ = base.shape
    truth = exact_topk(dev, queries, base, MetricType.INNER_PRODUCT)
    fp = Footprint()
    eng = family_engine("SCANN", "InnerProduct", {
        "ncentroids": 2048, "nsubvector": 32, "nprobe": 64,
        "train_iters": 8, "training_threshold": 2 * n,
        "store_dtype": "bfloat16"})
    index = eng.indexes["emb"]
    spent = {"_fit_codebooks": 0.0, "_encode_rows": 0.0}
    for name in spent:
        fn = getattr(index, name)

        def timed_hook(*a, _fn=fn, _name=name):
            t0 = time.monotonic()
            r = _fn(*a)
            torch.cuda.synchronize()
            spent[_name] += time.monotonic() - t0
            return r

        setattr(index, name, timed_hook)
    out = ingest_and_build(eng, base)
    eng.warmup([1024])
    out["footprint"] = fp.measure("SCANN", eng)
    out["anisotropic_train_s"] = spent["_fit_codebooks"]
    out["anisotropic_encode_s"] = spent["_encode_rows"]
    out["eta"] = index.eta
    for depth in (128, 512):
        out[f"full_rerank{depth}"], _ = run_path(
            eng, queries, {"rerank": depth}, truth)
        check(out[f"full_rerank{depth}"]["launches"]["int8_blockmax_scan"]
              > 0, "SCANN full scan never launched the block-max kernel")
    t0 = time.monotonic()
    index._publish()
    torch.cuda.synchronize()
    out["publish_s"] = time.monotonic() - t0
    for depth in (128, 512):
        p = {"scan_mode": "probe", "nprobe": 64, "rerank": depth}
        out[f"probe_rerank{depth}"], _ = run_path(eng, queries, p, truth)
        check(out[f"probe_rerank{depth}"]["launches"]["ivf_probe_dots"] > 0,
              "SCANN probe regime never launched the probe-dots kernel")
    return out


def family_hnsw_scan(dev, base, queries, truth) -> dict:
    """HNSW in scan mode (the port's "auto"), full width."""
    n, _ = base.shape
    fp = Footprint()
    eng = family_engine("HNSW", "L2", {"nlinks": 32, "efSearch": 64,
                                       "efConstruction": 160,
                                       "store_dtype": "bfloat16"})
    check(eng.indexes["emb"]._graph is None, "HNSW auto did not scan")
    out = ingest_and_build(eng, base)
    eng.warmup([1024])
    out["footprint"] = fp.measure("HNSW scan", eng)
    out["scan"], res = run_path(eng, queries, {}, truth)
    check(out["scan"]["launches"]["int8_blockmax_scan"] > 0,
          "HNSW scan mode never launched the block-max kernel")
    out["deleted"] = check_deletes(eng, queries, res, [{}], n, seed=3)
    return out


def build_graph_engine(rows) -> tuple:
    """HNSW in graph mode over `rows` (nlinks 32, efConstruction 160):
    the host graph, built on its own thread while the card works."""
    eng = family_engine("HNSW", "L2", {"graph": True, "nlinks": 32,
                                       "efSearch": 64, "efConstruction": 160})
    return eng, ingest_and_build(eng, rows, step=25_000)


def family_hnsw_graph(dev, rows, queries, built) -> dict:
    """HNSW graph mode, reduced (GRAPH_ROWS rows, GRAPH_B queries): the
    graph walks on the host, so the card only holds the result."""
    from vearch_tpu_torch.engine.types import MetricType

    t0 = time.monotonic()
    eng, out = built.result()
    out["waited_s"] = time.monotonic() - t0
    truth = exact_topk(dev, queries, rows, MetricType.L2)
    out["graph"], _ = run_path(eng, queries, {}, truth)
    out["graph"]["per_query_us"] = out["graph"]["search_ms"] * 1e3 / len(
        queries)
    return out


def family_hnsw_quantizer(dev, rows, queries) -> dict:
    """IVFPQ with quantizer_type hnsw, probe regime at nprobe 64,
    reduced to HNSWQ_ROWS rows and 1024 centroids (per_index.py's
    scale): the coarse graph is built at train time on the host."""
    import torch

    from vearch_tpu_torch.engine.types import MetricType

    truth = exact_topk(dev, queries, rows, MetricType.L2)
    eng = family_engine("IVFPQ", "L2", {
        "ncentroids": 1024, "nsubvector": 32, "nprobe": 64,
        "quantizer_type": "hnsw", "scan_mode": "probe", "train_iters": 8,
        "training_threshold": 2 * len(rows), "store_dtype": "bfloat16"})
    out = ingest_and_build(eng, rows)
    index = eng.indexes["emb"]
    check(index._coarse_graph is not None, "no coarse graph")
    t0 = time.monotonic()
    probes = index._host_probes(queries, 64)
    torch.cuda.synchronize()
    out["host_probe_ms"] = (time.monotonic() - t0) * 1e3
    out["short_probe_slots"] = int((probes < 0).sum())
    for depth in (128, 512):
        out[f"probe_rerank{depth}"], _ = run_path(
            eng, queries, {"rerank": depth}, truth)
        check(out[f"probe_rerank{depth}"]["launches"]["ivf_probe_dots"] > 0,
              "HNSW host probes never launched the probe-dots kernel")
    return out


def family_binaryivf(dev, n=1_000_000, bits=256, b=1024, seed=0) -> dict:
    """BINARYIVF: n random bit vectors (as tests/test_index_family.py's
    test_binaryivf_hamming), 1024 centroids, nprobe 64; every query is a
    stored row and must find itself at Hamming 0. Recall counts a hit
    when its Hamming distance is at most the exact 10th distance (the
    distances are integers, so ties are common)."""
    import torch

    rng = np.random.default_rng(seed)
    unpacked = rng.integers(0, 2, (n, bits), dtype=np.uint8)
    packed = np.packbits(unpacked, axis=1)
    qi = rng.choice(n, b, replace=False)
    eng = family_engine("BINARYIVF", "L2", {
        "ncentroids": 1024, "nprobe": 64, "train_iters": 8,
        "training_threshold": 2 * n, "store_dtype": "bfloat16"}, d=bits)
    out = ingest_and_build(eng, packed)
    # exact Hamming distances on the card: |q| + |x| - 2 q.x, exact
    # small integers in f32
    base_f = torch.from_numpy(unpacked).to(dev).float()
    pop = base_f.sum(1)
    q_f = base_f[torch.from_numpy(qi).to(dev)]
    dist = torch.cat([q_f[lo:lo + 128].sum(1)[:, None] + pop[None, :]
                      - 2.0 * (q_f[lo:lo + 128] @ base_f.T)
                      for lo in range(0, b, 128)])
    kth = torch.topk(dist, 10, dim=1, largest=False).values[:, -1]
    del base_f, pop, q_f

    def hamming_recall(res, _truth):
        hits = 0
        for row, keys in enumerate(res.keys):
            ids = torch.tensor([int(k[1:]) for k in keys], device=dev)
            hits += int((dist[row, ids] <= kth[row]).sum())
        return hits / (10 * b)

    queries = packed[qi]
    out["search"], res = run_path(eng, queries, {}, None,
                                  recall=hamming_recall)
    check(all(len(row) == 10 for row in res.keys), "short result rows")
    check([row[0] for row in res.keys] == [f"d{i}" for i in qi],
          "a stored row did not find itself")
    check(bool((res.scores.reshape(b, 10)[:, 0] == 0.0).all()),
          "a self-match is not at Hamming 0")
    out["cap"] = eng.indexes["emb"]._cap
    out["mean_bucket_len"] = n / 1024
    del dist
    return out


def phase_family(dev, base, queries, truth, graph_build) -> dict:
    """The rest of the index family through Engine; each engine is freed
    before the next is built."""
    out = {}
    for name, fn in (
        ("ivfrabitq", lambda: family_rabitq(dev, base, queries, truth)),
        ("scann", lambda: family_scann(dev, base, queries)),
        ("hnsw_scan", lambda: family_hnsw_scan(dev, base, queries, truth)),
        ("ivfpq_hnsw_quantizer", lambda: family_hnsw_quantizer(
            dev, base[:HNSWQ_ROWS], queries)),
        ("binaryivf", lambda: family_binaryivf(dev, n=len(base))),
        ("hnsw_graph", lambda: family_hnsw_graph(
            dev, base[:GRAPH_ROWS], queries[:GRAPH_B], graph_build)),
    ):
        t0 = time.monotonic()
        out[name] = fn()
        release_device_memory()
        out[name]["seconds"] = time.monotonic() - t0
        print(f"family {name}: {out[name]['seconds']:.1f}s "
              + json.dumps(out[name]), flush=True)
    out["reduced"] = REDUCED
    return out


# the engine phase's scalar filters (cat < 10 ~10%, tag = t3
# ~12.5%, both ~1.25% through the (tag, cat) composite)
ENGINE_FILTERS = {
    "cat_lt_10": {"operator": "AND", "conditions": [
        {"field": "cat", "operator": "<", "value": 10}]},
    "tag_t3": {"operator": "AND", "conditions": [
        {"field": "tag", "operator": "=", "value": "t3"}]},
    "tag_t3_and_cat_lt_10": {"operator": "AND", "conditions": [
        {"field": "tag", "operator": "=", "value": "t3"},
        {"field": "cat", "operator": "<", "value": 10}]},
}
ENGINE_REGIMES = {"full": GATED_PARAMS, "probe": dict(PROBE_PARAMS,
                                                      **GATED_PARAMS)}


def engine_docs(base, seed=10):
    """The main path's rows with two scalar fields from a seeded
    generator: `cat` uniform in [0, 100), `tag` one of t0..t7."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, 100, len(base)).astype(np.int32)
    tags = rng.integers(0, 8, len(base))
    return cats, tags


def engine_request(queries, params, **kw):
    from vearch_tpu_torch.engine.engine import SearchRequest

    kw.setdefault("raw_results", True)
    return SearchRequest(vectors={"emb": queries}, k=10, include_fields=[],
                         index_params=params, **kw)


def filtered_oracle(dev, store, queries, valid, k=10):
    """Exact filtered top-k on the card: f32 scores of the bf16-rounded
    queries against the rows as the store holds them (bf16), masked,
    128 queries at a time. Returns ([B, k] L2 distances, [B, k] row
    ids)."""
    import torch

    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.ops.distance import similarity_scores

    base_d, base_sq, n = store.device_buffer()
    q = torch.from_numpy(queries).to(dev).to(base_d.dtype)
    mask = torch.from_numpy(valid).to(dev)
    dist, ids = [], []
    for lo in range(0, q.shape[0], 128):
        s = similarity_scores(q[lo:lo + 128], base_d[:n], MetricType.L2,
                              base_sq[:n])
        s = torch.where(mask[None, :], s, torch.full_like(s, -np.inf))
        top = torch.topk(s, k, dim=1)
        dist.append(-top.values)
        ids.append(top.indices)
    return torch.cat(dist).cpu().numpy(), torch.cat(ids).cpu().numpy()


def check_against_oracle(res, dist, ids, what) -> int:
    """brute_force ids equal to the oracle's, position by position,
    except where the two scores tie (SCORE_TOL). Returns the tie swaps."""
    swaps = 0
    scores = np.asarray(res.scores).reshape(len(res.keys), -1)
    for row, keys in enumerate(res.keys):
        got = [int(k[1:]) for k in keys]
        check(len(got) == ids.shape[1], f"{what}: short row {row}")
        for j, g in enumerate(got):
            if g != ids[row, j]:
                swaps += 1
                check(np.isclose(scores[row, j], dist[row, j],
                                 rtol=SCORE_TOL[0], atol=SCORE_TOL[1]),
                      f"{what}: row {row} slot {j}: {g} vs {ids[row, j]} "
                      f"at {scores[row, j]} vs {dist[row, j]}")
    return swaps


def timed_search(eng, req, iters=3):
    """(result, mean wall ms of `iters` synced searches after one)."""
    import torch

    res = eng.search(req)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(iters):
        eng.search(req)
    torch.cuda.synchronize()
    return res, (time.monotonic() - t0) / iters * 1e3


def engine_filtered(dev, eng, queries, alive) -> tuple[dict, dict]:
    """Each filter through the full scan (rerank 512) and the probe
    regime (nprobe 64): the index mask byte-equal to the column scan's,
    every returned id alive and passing, brute_force equal to the exact
    filtered oracle; recall@10 and ms of each indexed path."""
    from vearch_tpu_torch.scalar.filter import evaluate_filter

    n = eng.table.doc_count
    out, paths = {}, {}
    for fname, flt in ENGINE_FILTERS.items():
        t0 = time.monotonic()
        mask = eng._filtered_mask(flt, n)
        mask_ms = (time.monotonic() - t0) * 1e3
        mgr, eng._scalar_manager = eng._scalar_manager, None
        try:
            scan = alive & evaluate_filter(flt, eng, n)
        finally:
            eng._scalar_manager = mgr
        check(mask.tobytes() == scan.tobytes(),
              f"{fname}: scalar-index mask differs from the column scan")
        dist, ids = filtered_oracle(dev, eng.vector_stores["emb"], queries,
                                    mask)
        truth = ids
        entry = {"matches": int(mask.sum()), "mask_ms": mask_ms}
        for regime, params in ENGINE_REGIMES.items():
            reset_launches()
            res, ms = timed_search(eng, engine_request(queries, params,
                                                       filters=flt))
            launches = read_launches()
            got = np.asarray([int(k[1:]) for row in res.keys for k in row],
                             dtype=np.int64)
            check(all(len(row) == 10 for row in res.keys),
                  f"{fname} {regime}: short rows")
            check(bool(mask[got].all()),
                  f"{fname} {regime}: a returned id is deleted or fails "
                  "the filter")
            entry[regime] = {"params": params, "search_ms": ms,
                             "recall_at_10": recall_at_10(res, truth),
                             "launches": launches}
            paths[f"filtered_{fname}_{regime}"] = entry[regime]
        kernel = {"full": "int8_blockmax_scan", "probe": "ivf_probe_dots"}
        for regime, name in kernel.items():
            check(entry[regime]["launches"][name] > 0,
                  f"{fname} {regime}: {name} never launched")
        res, ms = timed_search(eng, engine_request(
            queries, {}, filters=flt, brute_force=True), iters=1)
        entry["brute_force"] = {"search_ms": ms, "tie_swaps":
                                check_against_oracle(res, dist, ids, fname)}
        out[fname] = entry
        print(f"engine_filter {fname} " + json.dumps(entry), flush=True)
    return out, paths


def engine_snapshot(eng, queries, keys) -> dict:
    """What must come back equal after dump/open: doc_count, `get` on
    `keys`, a `query` page, and the ids of the bench, gated, probe and
    filtered requests."""
    snap = {"doc_count": eng.doc_count, "get": eng.get(keys),
            "query": eng.query(ENGINE_FILTERS["tag_t3"], limit=50,
                               offset=100)}
    reqs = {"bench": BENCH_PARAMS, "gated": GATED_PARAMS,
            "probe": dict(PROBE_PARAMS, **BENCH_PARAMS)}
    for name, params in reqs.items():
        snap[name] = eng.search(engine_request(queries, params)).keys
    for fname, flt in ENGINE_FILTERS.items():
        for regime, params in ENGINE_REGIMES.items():
            snap[f"{fname}_{regime}"] = eng.search(engine_request(
                queries, params, filters=flt)).keys
    return snap


@contextlib.contextmanager
def timed_methods(targets: dict):
    """Seconds spent in each {name: (class, method)} while the block runs
    (the card synchronised at each exit); the methods are restored
    after."""
    import torch

    spent = {name: 0.0 for name in targets}
    own = {name: cls.__dict__.get(attr)
           for name, (cls, attr) in targets.items()}
    for name, (cls, attr) in targets.items():
        def hook(*a, _fn=getattr(cls, attr), _name=name, **kw):
            t0 = time.monotonic()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[_name] += time.monotonic() - t0

        setattr(cls, attr, hook)
    try:
        yield spent
    finally:
        for name, (cls, attr) in targets.items():
            if own[name] is None:
                delattr(cls, attr)
            else:
                setattr(cls, attr, own[name])


def engine_reopen(eng, queries, keys) -> tuple:
    """dump to local disk, Engine.open (cuda by default), build_index
    (absorb only); everything in `engine_snapshot` equal before and
    after. Returns (numbers, the reopened engine, its launches)."""
    import tempfile

    import torch

    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.raw_vector import RawVectorStore
    from vearch_tpu_torch.index.ivf import IVFPQIndex
    from vearch_tpu_torch.scalar.manager import ScalarIndexManager

    before = engine_snapshot(eng, queries, keys)
    tmp = tempfile.mkdtemp(prefix="vearch_engine_dump_")
    try:
        t0 = time.monotonic()
        eng.dump(tmp)
        out = {"dump_s": time.monotonic() - t0}
        out["mb_written"] = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _d, files in os.walk(tmp) for f in files) / 2 ** 20
        eng.close()
        del eng
        release_device_memory()
        t0 = time.monotonic()
        # the open's parts: segments read (table and rows, the rows
        # alone), the index re-absorb, the scalar indexes rebuilt
        with timed_methods({
                "segments_s": (Engine, "_load_segmented"),
                "rows_s": (RawVectorStore, "load_parts"),
                "index_load_state_s": (IVFPQIndex, "load_state"),
                "scalar_rebuild_s": (ScalarIndexManager,
                                     "rebuild_from_table")}) as split:
            eng2 = Engine.open(tmp)
        out["open_s"] = time.monotonic() - t0
        out["open_split"] = split
        check(eng2.device.type == "cuda", "Engine.open did not default "
              "to cuda")
        t0 = time.monotonic()
        eng2.build_index()
        torch.cuda.synchronize()
        out["absorb_s"] = time.monotonic() - t0
        reset_launches()
        t0 = time.monotonic()
        eng2.search(engine_request(queries, BENCH_PARAMS))
        torch.cuda.synchronize()
        out["first_search_ms"] = (time.monotonic() - t0) * 1e3
        after = engine_snapshot(eng2, queries, keys)
        out["launches"] = read_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in before:
        check(before[name] == after[name],
              f"{name} differs after dump/open")
    out["equal_after_reopen"] = sorted(before)
    for name in ("int8_blockmax_scan", "ivf_probe_dots"):
        check(out["launches"][name] > 0,
              f"the reopened engine never launched {name}")
    return out, eng2


def engine_scheduled(eng, queries, threads=8, rows=128) -> dict:
    """`threads` callers each submit one `rows`-query request at the same
    moment through Engine.search (the scheduler); the results must be
    bit-identical to the same requests served one at a time through
    _search_direct."""
    import threading

    import torch

    reqs = [engine_request(queries[i * rows:(i + 1) * rows], BENCH_PARAMS,
                           raw_results=False) for i in range(threads)]
    eng.search(reqs[0])  # the scheduler's thread exists before the clock
    torch.cuda.synchronize()
    out: list = [None] * threads
    errors: list = []
    gate = threading.Barrier(threads + 1)

    def caller(i):
        try:
            gate.wait()
            out[i] = eng.search(reqs[i])
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    workers = [threading.Thread(target=caller, args=(i,))
               for i in range(threads)]
    for t in workers:
        t.start()
    reset_launches()
    mb = eng._microbatcher
    before = mb.stats()
    gate.wait()
    t0 = time.monotonic()
    for t in workers:
        t.join()
    torch.cuda.synchronize()
    scheduled_ms = (time.monotonic() - t0) * 1e3
    launches = read_launches()
    check(not errors, f"scheduled searches failed: {errors}")
    after = mb.stats()
    reset_launches()
    t0 = time.monotonic()
    direct = [eng._search_direct(r) for r in reqs]
    torch.cuda.synchronize()
    direct_ms = (time.monotonic() - t0) * 1e3
    direct_launches = read_launches()

    def items(res):
        return [[(it.key, it.score) for it in r.items] for r in res]

    check(all(items(o) == items(d) for o, d in zip(out, direct)),
          "scheduled results are not bit-identical to direct ones")
    check(launches["int8_blockmax_scan"] > 0,
          "the scheduled path never launched the block-max kernel")
    res = {"threads": threads, "rows_each": rows,
           "scheduled_wall_ms": scheduled_ms, "direct_wall_ms": direct_ms,
           "stats": {k: after[k] - before.get(k, 0)
                     if isinstance(after[k], int) else after[k]
                     for k in after},
           "launches": launches, "direct_launches": direct_launches,
           "bit_identical": True}
    print("engine_scheduled " + json.dumps(res), flush=True)
    return res


def phase_engine(dev, base, queries) -> tuple[dict, dict]:
    """The rest of the engine at the main path's size: two scalar fields
    with INVERTED, BITMAP and composite indexes, 1% deleted; filtered
    searches through both kernels, dump/open, the batch scheduler, then
    warmup, apply_config and close. Returns (numbers, per-path
    launches)."""
    import threading

    import torch

    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, ScalarIndexType,
        TableSchema,
    )

    (n, d), batch = base.shape, 1024
    params = {"ncentroids": 2048, "nsubvector": 32, "train_iters": 8,
              "training_threshold": 2 * n, "store_dtype": "bfloat16"}
    schema = TableSchema("engine", [
        FieldSchema("emb", DataType.VECTOR, dimension=d,
                    index=IndexParams("IVFPQ", MetricType.L2, params)),
        FieldSchema("cat", DataType.INT,
                    scalar_index=ScalarIndexType.INVERTED),
        FieldSchema("tag", DataType.STRING,
                    scalar_index=ScalarIndexType.BITMAP),
    ], composite_indexes=[["tag", "cat"]])
    eng = Engine(schema)
    cats, tags = engine_docs(base)
    t0 = time.monotonic()
    for i in range(0, n, 100_000):
        eng.upsert([{"_id": f"d{j}", "emb": base[j], "cat": int(cats[j]),
                     "tag": f"t{tags[j]}"}
                    for j in range(i, min(i + 100_000, n))])
    out = {"ingest_s": time.monotonic() - t0}
    t0 = time.monotonic()
    eng.build_index()
    torch.cuda.synchronize()
    out["build_s"] = time.monotonic() - t0
    rng = np.random.default_rng(11)
    gone = rng.choice(n, n // 100, replace=False)
    check(eng.delete([f"d{j}" for j in gone]) == len(gone), "delete count")
    q = queries[:batch]
    alive = eng.bitmap.valid_mask(n)
    out["filtered"], paths = engine_filtered(dev, eng, q, alive)
    keys = [f"d{j}" for j in gone[:50]] + [
        f"d{j}" for j in rng.choice(n, 50, replace=False)]
    out["reopen"], eng = engine_reopen(eng, q, keys)
    paths["reopened"] = out["reopen"]
    print("engine_reopen " + json.dumps(out["reopen"]), flush=True)
    out["scheduled"] = engine_scheduled(eng, q)
    paths["scheduled"] = out["scheduled"]
    t0 = time.monotonic()
    warmed = eng.warmup([64, 1024])
    torch.cuda.synchronize()
    out["warmup"] = {"batches": warmed, "s": time.monotonic() - t0}
    eng.apply_config({"micro_batch": False})
    eng.close()
    res = eng.search(engine_request(q[:64], BENCH_PARAMS, raw_results=False))
    check(len(res) == 64 and eng._microbatcher is None,
          "a search after close() did not serve directly")
    left = [t.name for t in threading.enumerate()
            if t.name == "vearch-batch-scheduler"]
    check(not left, f"scheduler threads left after close(): {left}")
    out["closed"] = {"direct_after_close": True, "scheduler_threads": 0}
    del eng, res
    release_device_memory()
    return out, paths


# -- phase_disk: disk and tiered storage ------------------------------------

DISK_PARAMS = {"ncentroids": 2048, "nprobe": 64, "train_iters": 8}
RESIDENT_MB, TIERED_MB = 4096, 512  # every slab fits; the default budget
MIX_GROUPS, MIX_B, MIX_WARM, MIX_MEAS = 32, 8, 12, 8  # bench.py's mix


def disk_engine(index_type, params, data_dir, metric="L2", d=128):
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import (
        DataType, FieldSchema, IndexParams, MetricType, TableSchema,
    )

    schema = TableSchema("disk", [FieldSchema(
        "emb", DataType.VECTOR, dimension=d,
        index=IndexParams(index_type, MetricType(metric), params))])
    return Engine(schema, data_dir=data_dir)


def build_disk_graph_engine(rows, data_dir) -> tuple:
    """HNSW with graph "auto" on a Disk store over `rows` (the graph is
    picked because the store is on disk), built on its own thread while
    the card works, as build_graph_engine."""
    eng = disk_engine("HNSW", {"store_type": "Disk", "nlinks": 32,
                               "efSearch": 64, "efConstruction": 160},
                      data_dir)
    return eng, ingest_and_build(eng, rows, step=25_000)


def h2d_total() -> int:
    return perf_model.h2d_bytes_total()


def disk_split(eng, req) -> dict:
    """Seconds of one search in each part of the disk path (the card
    synchronised at each part's exit): coarse probes, slab resolution
    (its uploads: RAM tier or mmap fetch, slab assembly, H2D), the
    cached bucket scan (the probe-dots kernel, epilogue, top-r), the
    host row gather of the rerank candidates, the rerank itself."""
    from vearch_tpu_torch.engine.disk_vector import DiskRawVectorStore
    from vearch_tpu_torch.index.hbm_cache import HbmBucketCache
    from vearch_tpu_torch.ops import ivf as ivf_ops

    t0 = time.monotonic()
    with timed_methods({
            "coarse_s": (ivf_ops, "_coarse_probes"),
            "resolve_s": (HbmBucketCache, "acquire"),
            "upload_s": (HbmBucketCache, "_upload"),
            "scan_s": (ivf_ops, "cached_bucket_scan"),
            "row_gather_s": (DiskRawVectorStore, "get_rows"),
            "rerank_s": (ivf_ops, "exact_rerank_gathered")}) as spent:
        eng.search(req)
    return dict(spent, total_s=time.monotonic() - t0)


def tier_search(eng, queries, params, truth, iters=3, split=False) -> dict:
    """One DISKANN request: the first search and the mean of `iters`
    more (ms), H2D bytes of each from the ledger, recall@10, the
    probe-dots launches of the first (set to 0 just before it); with
    `split`, one more search split by part and one profiled."""
    import torch

    req = family_request(queries, params)
    reset_launches()
    h0 = h2d_total()
    t0 = time.monotonic()
    res = eng.search(req)
    torch.cuda.synchronize()
    out = {"params": params, "B": len(queries),
           "first_ms": (time.monotonic() - t0) * 1e3,
           "first_h2d_bytes": h2d_total() - h0,
           "launches": read_launches(), "recall_at_10": recall_at_10(
               res, truth)}
    h0 = h2d_total()
    t0 = time.monotonic()
    for _ in range(iters):
        eng.search(req)
    torch.cuda.synchronize()
    out["warm_ms"] = (time.monotonic() - t0) * 1e3 / iters
    out["warm_h2d_bytes_per_search"] = (h2d_total() - h0) / iters
    out["qps"] = len(queries) * 1e3 / out["warm_ms"]
    if split:
        out["split_s"] = disk_split(eng, req)
        out["profile"] = profile_search(eng, req)
    print("disk_search " + json.dumps(out), flush=True)
    check(out["launches"]["ivf_probe_dots"] > 0,
          f"DISKANN {params} never launched the probe-dots kernel")
    return out, res


def set_cache_mb(eng, mb) -> None:
    """The slab cache's device budget, through apply_config's
    index_params; the next search rebuilds the cache at that size."""
    eng.apply_config({"index_params": {"emb": {"cache_mb": mb}}})


def tier_budget(eng, queries, truth, mb) -> dict:
    """The DISKANN searches of one cache budget: the default rerank
    (first and warmed) and rerank 512, with the passes it takes."""
    set_cache_mb(eng, mb)
    index = eng.indexes["emb"]
    out = {"cache_mb": mb}
    out["default"], res = tier_search(eng, queries, {}, truth, split=True)
    out["gated"], _ = tier_search(eng, queries, GATED_PARAMS, truth, iters=1)
    probes = coarse_probes(index, queries, DISK_PARAMS["nprobe"])
    out["distinct_buckets"] = int(np.unique(probes).size)
    out["passes"] = len(index._cache.plan_passes(probes))
    out["tiering_info"] = eng.tiering_info()
    print(f"disk_budget {mb} " + json.dumps(out), flush=True)
    check(out["gated"]["recall_at_10"] >= 0.95,
          f"DISKANN cache_mb {mb}: recall@10 "
          f"{out['gated']['recall_at_10']} < 0.95 at rerank 512")
    return out, res


def coarse_probes(index, queries, nprobe) -> np.ndarray:
    from vearch_tpu_torch.ops.ivf import _coarse_probes

    q = index._to_device(np.asarray(queries, np.float32))
    return _coarse_probes(q, index.centroids, nprobe).cpu().numpy()


def tiering_mix(eng, queries, mb_tiered, mb_resident) -> dict:
    """bench.py's tiered_storage_bench mix at the main rows: MIX_GROUPS
    fixed MIX_B-query groups of the main queries drawn Zipf(1.1) with
    seed 11, MIX_WARM x groups warm searches then MIX_MEAS x groups
    measured, on the tiered budget; then the same measured draw on the
    resident budget, warmed on its first quarter. Searches go to the
    index directly, as the bench's do."""
    import torch

    index = eng.indexes["emb"]
    rng = np.random.default_rng(11)
    groups = [queries[g * MIX_B:(g + 1) * MIX_B] for g in range(MIX_GROUPS)]
    w = 1.0 / np.power(np.arange(1, MIX_GROUPS + 1), 1.1)
    order = rng.choice(MIX_GROUPS, size=MIX_WARM * MIX_GROUPS, p=w / w.sum())
    meas = rng.choice(MIX_GROUPS, size=MIX_MEAS * MIX_GROUPS, p=w / w.sum())
    set_cache_mb(eng, mb_tiered)
    with index._absorb_lock:
        cache = index._ensure_cache()
    cache.invalidate()  # a cold start at this budget
    reset_launches()
    h0 = h2d_total()
    index.search(groups[0], 10, None)
    torch.cuda.synchronize()
    cold = h2d_total() - h0
    t0 = time.monotonic()
    for g in order:  # warm: pins form, the predictor learns
        index.search(groups[int(g)], 10, None)
    index._prefetcher.drain()
    warm_s = time.monotonic() - t0
    st0 = index._cache.stats()
    h0 = h2d_total()
    t0 = time.monotonic()
    for g in meas:
        index.search(groups[int(g)], 10, None)
    torch.cuda.synchronize()
    dt_tiered = time.monotonic() - t0
    index._prefetcher.drain()
    st1 = index._cache.stats()
    steady = h2d_total() - h0
    launches = read_launches()
    lookups = st1["hits"] + st1["misses"] - st0["hits"] - st0["misses"]
    hits = st1["hits"] - st0["hits"]
    served = (st1["pin_hits"] + st1["prefetch_hits"]
              - st0["pin_hits"] - st0["prefetch_hits"])
    set_cache_mb(eng, mb_resident)
    for g in meas[: len(meas) // 4]:  # warm the resident budget too
        index.search(groups[int(g)], 10, None)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for g in meas:
        index.search(groups[int(g)], 10, None)
    torch.cuda.synchronize()
    dt_resident = time.monotonic() - t0
    nq = len(meas) * MIX_B
    out = {"groups": MIX_GROUPS, "group_b": MIX_B,
           "warm_searches": len(order), "measured_searches": len(meas),
           "hbm_slots": st1["slots"], "slab_bytes": st1["slab_bytes"],
           "warm_s": warm_s,
           "cold_h2d_bytes_per_query": cold / MIX_B,
           "steady_h2d_bytes_per_query": steady / nq,
           "steady_hit_rate": hits / max(lookups, 1),
           "pin_prefetch_share": served / max(lookups, 1),
           "tiered_qps": nq / dt_tiered, "resident_qps": nq / dt_resident,
           "tiering_qps_cost_pct": 100.0 * (1 - dt_resident / dt_tiered),
           "launches": launches,
           "prefetch": index.tiering_info()["prefetch"]}
    print("disk_mix " + json.dumps(out), flush=True)
    check(launches["ivf_probe_dots"] > 0,
          "the tiering mix never launched the probe-dots kernel")
    return out


def disk_recovery(eng, data_dir, queries, keys_before, rows) -> tuple:
    """Tail rows past the index's durable count, Engine.dump in place
    (segments, flush_disk, the scan files flushed), close, Engine.open:
    the bucket lists rebuilt from assign.i32 and only the tail absorbed.
    The ids of the resident search must come back equal."""
    import torch

    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.index.disk import DiskANNIndex

    n = eng.vector_stores["emb"].count
    eng.upsert([{"_id": f"t{j}", "emb": rows[j]} for j in range(len(rows))])
    t0 = time.monotonic()
    eng.dump()
    out = {"tail_rows": len(rows), "dump_s": time.monotonic() - t0}
    out["segment_mb"] = sum(
        os.path.getsize(os.path.join(dp, f))
        for dp, _d, files in os.walk(os.path.join(data_dir, "segments"))
        for f in files) / 2 ** 20
    eng.close()
    del eng
    release_device_memory()
    t0 = time.monotonic()
    with timed_methods({
            "segments_s": (Engine, "_load_segmented"),
            "index_load_state_s": (DiskANNIndex, "load_state"),
            "tail_absorb_s": (DiskANNIndex, "absorb")}) as split:
        eng2 = Engine.open(data_dir)
    out["open_s"] = time.monotonic() - t0
    out["open_split"] = split
    out["assign_rebuild_s"] = (split["index_load_state_s"]
                               - split["tail_absorb_s"])
    index = eng2.indexes["emb"]
    check(index.indexed_count == n + len(rows),
          f"reopened DISKANN indexed {index.indexed_count} of "
          f"{n + len(rows)}")
    set_cache_mb(eng2, RESIDENT_MB)
    reset_launches()
    t0 = time.monotonic()
    res = eng2.search(family_request(queries, {}))
    torch.cuda.synchronize()
    out["first_search_ms"] = (time.monotonic() - t0) * 1e3
    out["launches"] = read_launches()
    out["equal_ids_after_open"] = res.keys == keys_before
    print("disk_recovery " + json.dumps(out), flush=True)
    check(out["equal_ids_after_open"],
          "DISKANN ids differ after the in-place dump and open")
    return out, eng2


def tied_exact(dev, queries, base, got_keys, truth) -> int:
    """Rows whose returned ids differ from the exact ones other than by
    an f32 tie of the exact distances (checked on the card)."""
    import torch

    bad = 0
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    for i, row in enumerate(got_keys):
        got = [int(k[1:]) for k in row]
        if got == truth[i].tolist():
            continue
        ids = torch.tensor(sorted(set(got) | set(truth[i].tolist())),
                           device=dev)
        rows = torch.from_numpy(base[ids.cpu().numpy()]).to(dev)
        dist = ((rows - q[i]) ** 2).sum(1)
        kth = torch.sort(dist).values[9]
        mine = dist[torch.isin(ids, torch.tensor(got, device=dev))]
        if bool((mine > kth * (1 + 1e-5) + 1e-4).any()):
            bad += 1
    return bad


def disk_other_types(dev, base, queries, truth, tmp, graph_build) -> dict:
    """IVFPQ, IVFRABITQ and FLAT on a Disk store at the main rows, and
    HNSW auto (graph) on a Disk store at GRAPH_ROWS; each engine freed
    before the next."""
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.ops import binary_scan as bs
    from vearch_tpu_torch.ops import ivf as ivf_ops

    n = len(base)
    out = {}
    # IVFPQ: the main path's settings on a bf16 disk store
    ddir = os.path.join(tmp, "ivfpq")
    eng = disk_engine("IVFPQ", {
        "store_type": "Disk", "ncentroids": 2048, "nsubvector": 32,
        "train_iters": 8, "training_threshold": 2 * n,
        "store_dtype": "bfloat16"}, ddir)
    sub = ingest_and_build(eng, base)
    sub["gated"], _ = run_path(eng, queries, GATED_PARAMS, truth, iters=1)
    sub["profile"] = profile_search(eng, family_request(queries,
                                                        GATED_PARAMS))
    check(sub["gated"]["recall_at_10"] >= 0.95,
          f"IVFPQ on a Disk store: recall@10 "
          f"{sub['gated']['recall_at_10']} < 0.95 at rerank 512")
    check(sub["gated"]["launches"]["int8_blockmax_scan"] > 0,
          "IVFPQ on a Disk store never launched the block-max kernel")
    check("fused_scan_rerank" not in sub["gated"]["tags"],
          "IVFPQ on a Disk store took the fused scan + rerank")
    out["ivfpq_disk"] = sub
    eng.close()
    del eng
    release_device_memory()
    shutil.rmtree(ddir, ignore_errors=True)
    # IVFRABITQ, three stages, rerank on the host gather
    ddir = os.path.join(tmp, "rabitq")
    eng = disk_engine("IVFRABITQ", {
        "store_type": "Disk", "ncentroids": 2048, "train_iters": 8,
        "training_threshold": 2 * n, "store_dtype": "bfloat16"}, ddir)
    sub = ingest_and_build(eng, base)
    before = bs.refine_search_counts()["disk"]
    sub["three_stage"], _ = run_path(eng, queries, {"rerank": 256}, truth,
                                     iters=1)
    sub["refine_disk_searches"] = bs.refine_search_counts()["disk"] - before
    check(sub["three_stage"]["tags"] == ["binary_refine_scan", "rerank"],
          f"IVFRABITQ on a Disk store tags {sub['three_stage']['tags']}")
    check(sub["refine_disk_searches"] > 0,
          "IVFRABITQ on a Disk store counted no disk search")
    out["ivfrabitq_disk"] = sub
    eng.close()
    del eng
    release_device_memory()
    shutil.rmtree(ddir, ignore_errors=True)
    # FLAT: the exact scan streamed over the mmap
    ddir = os.path.join(tmp, "flat")
    eng = disk_engine("FLAT", {"store_type": "Disk"}, ddir)
    sub = ingest_and_build(eng, base)
    q = queries[:FLAT_DISK_B]
    sub["search"], res = run_path(eng, q, {}, truth[:FLAT_DISK_B], iters=1)
    sub["rows_not_exact"] = tied_exact(dev, q, base, res.keys,
                                       truth[:FLAT_DISK_B])
    check(sub["rows_not_exact"] == 0,
          f"FLAT on a Disk store: {sub['rows_not_exact']} rows differ "
          f"from exact search beyond f32 ties")
    out["flat_disk"] = sub
    eng.close()
    del eng
    release_device_memory()
    shutil.rmtree(ddir, ignore_errors=True)
    # HNSW auto on a Disk store: the graph, built on its own thread
    t0 = time.monotonic()
    eng, sub = graph_build.result()
    sub["waited_s"] = time.monotonic() - t0
    check(eng.indexes["emb"].use_graph and eng.indexes["emb"]._graph
          is not None, "HNSW auto on a Disk store did not pick the graph")
    rows, gq = base[:GRAPH_ROWS], queries[:GRAPH_B]
    gtruth = exact_topk(dev, gq, rows, MetricType.L2)
    sub["graph"], _ = run_path(eng, gq, {}, gtruth)
    sub["graph"]["per_query_us"] = sub["graph"]["search_ms"] * 1e3 / len(gq)
    out["hnsw_disk"] = sub
    eng.close()
    del eng
    release_device_memory()
    ivf_ops.set_dispatch_ledger(None)
    for name, res in out.items():
        print(f"disk_type {name} " + json.dumps(res), flush=True)
    return out


def phase_disk(dev, base, queries, truth, tmp, graph_build) -> tuple:
    """Disk and tiered storage at the main rows: DISKANN (2048 cells,
    nprobe 64) on a local-disk data_dir through Engine, at a resident
    and the default tiered cache budget; bench.py's tiering mix; the
    in-place dump and open; then the other index types on Disk stores.
    Returns (numbers, per-path launches)."""
    import torch

    (n, d), batch = base.shape, 1024
    q = queries[:batch]
    ddir = os.path.join(tmp, "diskann")
    fp = Footprint()
    eng = disk_engine("DISKANN", dict(
        DISK_PARAMS, training_threshold=2 * n, cache_mb=RESIDENT_MB), ddir)
    out = ingest_and_build(eng, base)
    index = eng.indexes["emb"]
    pops = index.cell_populations()
    out.update(cap=index._slab_cap(), longest_bucket=int(max(pops)),
               mean_bucket_len=float(np.mean(pops)),
               slab_bytes=index._slab_cap() * (d + 12))
    print("disk_build " + json.dumps(out), flush=True)
    out["resident"], res = tier_budget(eng, q, truth, RESIDENT_MB)
    out["footprint"] = fp.measure("DISKANN (resident slab pool)", eng)
    check(out["resident"]["default"]["warm_h2d_bytes_per_search"] == 0,
          "a warmed resident DISKANN search moved H2D bytes")
    keys_before = res.keys
    # the probe-dots kernel at the disk path's shape: the resolved slots
    # of this batch over the resident pools, against its plain version
    cache = index._cache
    probes = coarse_probes(index, q, DISK_PARAMS["nprobe"])
    slots, pools = cache.acquire(probes, dict(index._gens),
                                 index._make_fetch(dict(index._gens),
                                                   index.indexed_count))
    cache.release()
    out["kernel_case"] = compare_probe_case(
        "disk_B1024", torch.from_numpy(np.ascontiguousarray(q)).to(dev),
        torch.from_numpy(slots).to(dev), pools[0], pools[4])
    del pools, cache
    out["tiered"], _ = tier_budget(eng, q, truth, TIERED_MB)
    check(out["tiered"]["passes"] > 1,
          "the tiered budget took one pass; expected the multi-pass path")
    out["mix"] = tiering_mix(eng, queries, TIERED_MB, RESIDENT_MB)
    rng = np.random.default_rng(12)
    # tail rows far from every query: they cannot enter a top 10, so the
    # ids before and after the reopen compare
    tail = (rng.standard_normal((2048, d)) * 60).astype(np.float32)
    set_cache_mb(eng, RESIDENT_MB)
    out["recovery"], eng = disk_recovery(eng, ddir, q, keys_before, tail)
    out["recovery"]["cap_after"] = eng.indexes["emb"]._slab_cap()
    eng.close()
    del eng, index
    release_device_memory()
    shutil.rmtree(ddir, ignore_errors=True)
    out["types"] = disk_other_types(dev, base, q, truth, tmp, graph_build)
    out["reduced"] = {k: REDUCED[k] for k in ("flat_disk", "hnsw_disk")}
    paths = {"diskann": {
        "resident": out["resident"]["default"],
        "resident_gated": out["resident"]["gated"],
        "tiered": out["tiered"]["default"],
        "tiered_gated": out["tiered"]["gated"],
        "mix": out["mix"], "reopened": out["recovery"]},
        "disk_types": {
        "ivfpq": out["types"]["ivfpq_disk"]["gated"],
        "ivfrabitq": out["types"]["ivfrabitq_disk"]["three_stage"],
        "flat": out["types"]["flat_disk"]["search"],
        "hnsw_graph": out["types"]["hnsw_disk"]["graph"]}}
    return out, paths


# -- runtime truth: footprint models against the caching allocator ----------

FOOTPRINTS: list = []  # one row per Footprint.measure, in run order
# what a footprint model may leave out: the caching allocator rounds each
# tensor up to 512-byte blocks (448 B over the 8 rows of a full run on
# the H100), and one run left 0.8 MB unattributed; a model short by more,
# or over the allocation at all, fails
UNMODELLED_BOUND_BYTES = 2 << 20


class Footprint:
    """The device sampler around one engine's life: its baseline is what
    the caching allocator holds before the engine exists (the card
    emptied first), its model the engine's summed
    `device_footprint_bytes`; `measure` samples after a build and a
    warmup, with the card synchronised and no search in flight."""

    def __init__(self):
        import torch

        from vearch_tpu_torch.obs.sampler import DeviceSampler

        release_device_memory()
        torch.cuda.synchronize()
        self.engine = None
        self.sampler = DeviceSampler(
            lambda: (0 if self.engine is None
                     else self.engine.device_footprint_bytes()))
        self.sampler.sample_now()

    def measure(self, label, eng) -> dict:
        import torch

        from vearch_tpu_torch.obs.sampler import measure_reserved_bytes

        torch.cuda.synchronize()
        self.engine = eng
        try:
            snap = self.sampler.sample_now()
        finally:
            self.engine = None
        row = {"index": label, "model_bytes": snap["model_per_device_bytes"],
               "allocated_bytes": snap["devices"]["cuda:0"],
               "baseline_bytes": snap["baseline_per_device_bytes"]["cuda:0"],
               "reserved_bytes": measure_reserved_bytes()["cuda:0"],
               "drift_bytes": snap["drift_bytes"], "drift": snap["drift"]}
        row["unmodelled_bytes"] = (row["allocated_bytes"]
                                   - row["baseline_bytes"]
                                   - row["model_bytes"])
        FOOTPRINTS.append(row)
        print("footprint " + json.dumps(row), flush=True)
        return row


def main_engine(params, store_dtype="bfloat16", name="bench"):
    """An engine of the main path's index settings (IVFPQ, 2048
    centroids, 32 subvectors, 8 training iterations), with `params`
    added."""
    return family_engine("IVFPQ", "L2", dict({
        "ncentroids": 2048, "nsubvector": 32, "train_iters": 8,
        "training_threshold": 10 ** 9, "store_dtype": store_dtype},
        **params))


def runtime_flight(eng, queries, events) -> dict:
    """The compile events of the engine's build and warmup, then 20
    main-path searches through Engine.search (10 at B=1024, 10 at
    B=1000, padded to 1024): no new compile event may follow the
    warmup; the pad counters against perf_model's model."""
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.obs.flight_recorder import RECORDER

    total0, pad0 = RECORDER.total(), eng.pad_waste_bytes
    rows0 = (eng.pad_real_rows, eng.pad_padded_rows)
    for b in (1024, 1000):
        for _ in range(10):
            eng.search(SearchRequest(vectors={"emb": queries[:b]}, k=10,
                                     include_fields=[]))
    d = queries.shape[1]
    out = {"events_in_build_and_warmup": events,
           "recorder_total_before": total0,
           "recorder_total_after": RECORDER.total(),
           "warmup_compiles": RECORDER.warmup_compiles,
           "pad_real_rows": eng.pad_real_rows - rows0[0],
           "pad_padded_rows": eng.pad_padded_rows - rows0[1],
           "pad_waste_bytes": eng.pad_waste_bytes - pad0,
           "padding_waste_bytes_model": 10 * perf_model.padding_waste_bytes(
               1000, 1024, d)}
    print("runtime_flight " + json.dumps(out), flush=True)
    check(out["recorder_total_after"] == total0,
          f"compile events after warmup: {RECORDER.events()[-5:]}")
    check(out["pad_waste_bytes"] == out["padding_waste_bytes_model"],
          "pad waste bytes differ from perf_model's")
    return out


def runtime_tracking_cost(eng, queries, reps=200, iters=20) -> dict:
    """What program tracking (perf_model.register_op) adds to a small
    search through Engine.search: the tracked calls of one B=1 and one
    B=8 search, and the host time of their shape signatures and set
    lookups under the lock (all the wrapper does once a signature is
    known), beside the search's median wall time."""
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.obs.flight_recorder import RECORDER

    sig_of, out = perf_model.shape_signature, {}
    for b in (1, 8):
        req = SearchRequest(vectors={"emb": queries[:b]}, k=10,
                            include_fields=[])
        with RECORDER.warmup():  # not the serving warmup's batch sizes
            eng.search(req)
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            eng.search(req)
            walls.append((time.perf_counter() - t0) * 1e3)
        calls = []

        def recording(args, kwargs):
            calls.append((args, kwargs))
            return sig_of(args, kwargs)

        perf_model.shape_signature = recording
        try:
            eng.search(req)
        finally:
            perf_model.shape_signature = sig_of
        seen = {sig_of(a, kw) for a, kw in calls}
        t0 = time.perf_counter()
        for _ in range(reps):
            for a, kw in calls:
                sig = sig_of(a, kw)
                with perf_model._programs_lock:
                    _ = sig in seen
        us = (time.perf_counter() - t0) * 1e6 / reps
        ms = float(np.median(walls))
        out[f"b{b}"] = {"tracked_calls": len(calls), "tracking_us": us,
                        "search_ms": ms, "share": us / 1e3 / ms}
    print("runtime_tracking " + json.dumps(out), flush=True)
    return out


def runtime_accounting(eng, queries, threads=8, rows=128) -> dict:
    """Eight concurrent 128-query callers in two spaces through the batch
    scheduler: per-space device_us, queue_wait_us and dispatches; the
    apportioned device_us sum against the summed wall time of the runs;
    each request's trace["dispatches"] mapped to its documented path."""
    import threading

    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.obs import accounting as acct

    walls, lock = [], threading.Lock()
    inner = eng._search_direct

    def timed(req):
        t0 = time.monotonic()
        try:
            return inner(req)
        finally:
            with lock:
                walls.append((len(next(iter(req.vectors.values()))),
                              time.monotonic() - t0))

    accountant = acct.install()
    accountant.reset()
    eng._search_direct = timed
    traces = [{} for _ in range(threads)]
    start = threading.Barrier(threads)
    errors = []

    def caller(i):
        try:
            with acct.billed("db/a" if i % 2 else "db/b"):
                start.wait()
                eng.search(SearchRequest(
                    vectors={"emb": queries[i * rows:(i + 1) * rows]},
                    k=10, include_fields=[], trace=traces[i]))
        except Exception as e:  # reported by the check below
            errors.append(repr(e))

    pool = [threading.Thread(target=caller, args=(i,))
            for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=300)
    del eng._search_direct
    check(not errors and not any(t.is_alive() for t in pool),
          f"scheduled callers failed: {errors}")
    snap = accountant.snapshot()["spaces"]
    spaces = {sp: {m: snap[sp][m] for m in
                   ("device_us", "queue_wait_us", "dispatches")}
              for sp in ("db/a", "db/b")}
    device_us = sum(v["device_us"] for v in spaces.values())
    wall_us = sum(w for _, w in walls) * 1e6
    paths = [perf_model.path_for_dispatches(t.get("dispatches", []))
             for t in traces]
    out = {"spaces": spaces, "runs": len(walls),
           "grouped_runs": sum(r > rows for r, _ in walls),
           "device_us_sum": device_us, "runs_wall_us": wall_us,
           "paths": sorted(set(map(str, paths))),
           "system_device_us": snap.get(acct.SYSTEM_SPACE, {}).get(
               "device_us", 0)}
    print("runtime_accounting " + json.dumps(out), flush=True)
    check(abs(device_us - wall_us) <= 0.1 * wall_us,
          "apportioned device_us off the runs' wall time by more than 10%")
    check(all(p == "ivfpq_full_fused" for p in paths),
          f"traced dispatches left the documented path: {paths}")
    # a grouped run's discrete events bill to its head's space
    check(sum(v["dispatches"] for v in spaces.values()) == len(walls),
          "dispatches billed differ from the runs")
    check(all(v["device_us"] > 0 and v["queue_wait_us"] > 0
              for v in spaces.values()), "a space was not billed")
    accountant.reset()
    return out


def runtime_quality(dev, eng, base, queries, searches=16, rows=16) -> dict:
    """A QualityMonitor sampling every row of 16 searches of the engine
    (sample rate 1, no decay): its shadow brute_force searches run on the
    card; its recall estimate against this script's own recall@10 of the
    same served rows (exact f32 oracle), which must lie within the
    monitor's Wilson bounds; the health numbers with recon_error."""
    from vearch_tpu_torch.engine.engine import SearchRequest
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.obs.quality import QualityMonitor

    mon = QualityMonitor(get_engines=lambda: {0: eng}, sample_rate=1.0,
                         decay=0.0, min_samples=searches,
                         queue_cap=searches * rows)
    q = queries[:searches * rows]
    truth = exact_topk(dev, q, base, MetricType.L2)
    served = []
    t0 = time.monotonic()
    for i in range(searches):
        qi = q[i * rows:(i + 1) * rows]
        res = eng.search(SearchRequest(vectors={"emb": qi}, k=10,
                                       include_fields=[]))
        mon.observe_search(0, "db/main", {"emb": qi}, 10, res,
                           eng.data_version)
        served += [[int(it.key[1:]) for it in r.items] for r in res]
    t_serve = time.monotonic() - t0
    t0 = time.monotonic()
    executed = mon.run_pending()
    t_shadow = time.monotonic() - t0
    own = sum(len(set(g) & set(t.tolist()))
              for g, t in zip(served, truth)) / truth.size
    rec = mon.recall_snapshot()
    est = rec["spaces"]["db/main"]["recall"]["10"]
    health = mon.collect_health()[0]
    out = {"searches": searches, "rows": rows, "shadow_jobs": executed,
           "serve_s": t_serve, "shadow_s": t_shadow,
           "own_recall_at_10": own, "recall_snapshot": rec,
           "health_snapshot": mon.health_snapshot(),
           "recon_error": health["fields"]["emb"]["recon_error"]}
    print("runtime_quality " + json.dumps(out), flush=True)
    check(executed == searches * rows and
          rec["counters"]["executed"] == executed,
          f"shadow jobs executed {executed}")
    check(est["wilson_low"] <= own <= est["wilson_high"],
          f"own recall {own} outside the monitor's Wilson bounds {est}")
    return out


def phase_runtime(dev, base, queries, events) -> tuple:
    """Runtime truth on the card: the main path's index (f32 store, so
    the quality monitor's brute_force truth is this script's exact f32
    oracle) under the device sampler, the flight recorder, the
    accountant and the quality monitor; FLAT under the sampler (main
    prints the footprint table of every index type after phase 8).
    Returns (numbers, per-path launches)."""
    from vearch_tpu_torch.obs.flight_recorder import RECORDER

    out = {}
    fp = Footprint()
    eng = main_engine({"warmup_batches": [1000, 1024], "scan_mode": "full"},
                      store_dtype="float32")
    mark = len(events)
    out["ivfpq"] = ingest_and_build(eng, base)
    index = eng.indexes["emb"]
    out["ivfpq"]["recon_error"] = index.reconstruction_error()
    out["ivfpq"]["device_footprint_bytes"] = eng.device_footprint_bytes()
    out["ivfpq"]["mirror_device_bytes"] = index._mirror.device_bytes()
    fp.measure("IVFPQ int8 (full)", eng)
    reset_launches()
    out["flight"] = runtime_flight(eng, queries, events[mark:])
    out["flight"]["launches"] = read_launches()
    check(out["flight"]["launches"]["int8_blockmax_scan"] > 0,
          "the runtime engine's searches never launched the block-max "
          "kernel")
    out["tracking"] = runtime_tracking_cost(eng, queries)
    reset_launches()
    out["accounting"] = runtime_accounting(eng, queries)
    out["accounting"]["launches"] = read_launches()
    out["quality"] = runtime_quality(dev, eng, base, queries)
    # the probe regime published: one probe search, an explicit warmup
    # pass of that regime
    with RECORDER.warmup():
        eng.search(family_request(queries, PROBE_PARAMS))
    out["ivfpq"]["bucket_bytes"] = sum(
        t.numel() * t.element_size() for t in (
            index._bucket_resid8, index._bucket_scale, index._bucket_vsq,
            index._bucket_ids, index._bucket_lens))
    fp.measure("IVFPQ int8 (full and probe published)", eng)
    eng.close()
    del eng, index
    fp = Footprint()
    eng = family_engine("FLAT", "L2", {"store_dtype": "bfloat16",
                                       "warmup_batches": [1024]})
    out["flat"] = ingest_and_build(eng, base)
    fp.measure("FLAT", eng)
    eng.close()
    del eng
    release_device_memory()
    paths = {"runtime": {"flight": out["flight"],
                         "scheduled": out["accounting"]}}
    return out, paths


def footprint_table() -> list:
    """Every footprint measured in this run (phase_family, phase_disk,
    phase_runtime, phase_storage_modes); none may have drifted."""
    print("footprint_table " + json.dumps(FOOTPRINTS), flush=True)
    for row in FOOTPRINTS:
        check(not row["drift"], f"device bytes drifted from the model: "
              f"{row}")
        check(0 <= row["unmodelled_bytes"] <= UNMODELLED_BOUND_BYTES,
              f"allocated - baseline - model outside [0, "
              f"{UNMODELLED_BOUND_BYTES}] B: {row}")
    check(len(FOOTPRINTS) == 8, f"{len(FOOTPRINTS)} footprints measured")
    return list(FOOTPRINTS)


def phase_storage_modes(dev, base, queries, truth, ivfpq) -> tuple:
    """The build side's last storage modes at the main path's rows and
    settings (bf16 store): IVFPQ with an int4 mirror (full scan), IVFPQ
    with OPQ (full scan and probe regime), IVFRABITQ with an int4 stage-1
    tier. `ivfpq` holds phase_runtime's plain IVFPQ numbers. Returns
    (numbers, per-path launches)."""
    import torch

    from vearch_tpu_torch.ops import binary_scan as bs
    from vearch_tpu_torch.ops import ivf as ivf_ops

    (n, d), batch = base.shape, 1024
    q = queries[:batch]
    out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    print(f"storage: torch.backends.cuda.matmul.allow_tf32 = "
          f"{out['allow_tf32']}", flush=True)
    check(not out["allow_tf32"], "TF32 is on: the int4 scan's f32 "
          "products would be rounded")

    # -- IVFPQ, int4 mirror ------------------------------------------------
    fp = Footprint()
    eng = main_engine({"mirror_dtype": "int4", "scan_mode": "full",
                       "warmup_batches": [1024]})
    int4 = ingest_and_build(eng, base)
    index = eng.indexes["emb"]
    fp.measure("IVFPQ int4 (full)", eng)
    cap = index._mirror._h8.shape[0]
    int4.update(
        device_footprint_bytes=eng.device_footprint_bytes(),
        mirror_device_bytes=index._mirror.device_bytes(),
        int8_mirror_device_bytes=ivfpq["mirror_device_bytes"],
        mirror_payload_bytes=cap * index._mirror._h8.shape[1],
        int8_mirror_payload_bytes=cap * d)
    check(2 * int4["mirror_payload_bytes"]
          == int4["int8_mirror_payload_bytes"],
          "the int4 mirror's payload is not half of int8's")
    check(int4["mirror_device_bytes"] == perf_model.mirror_footprint_bytes(
        cap, d, "int4"), "int4 mirror bytes differ from the model")
    for depth in (128, 512):
        int4[f"rerank{depth}"], _ = run_path(eng, q, {"rerank": depth},
                                             truth)
        check(int4[f"rerank{depth}"]["tags"] == ["fused_scan_rerank"],
              f"int4 tags {int4[f'rerank{depth}']['tags']}")
    req = family_request(q, GATED_PARAMS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.search(req)
    torch.cuda.synchronize()
    int4["search_peak_bytes"] = torch.cuda.max_memory_allocated() - before
    int4["scan_peak_bytes_model"] = perf_model.scan_peak_bytes(
        batch, cap, d, 512, "xla_full")
    int4["profile"] = profile_search(eng, req, ivf_ops.INT4_RANGES)
    out["ivfpq_int4"] = int4
    print("storage_int4 " + json.dumps(int4), flush=True)
    check(int4["rerank512"]["recall_at_10"] >= 0.95,
          f"int4 recall@10 {int4['rerank512']['recall_at_10']} < 0.95 at "
          "rerank 512")
    eng.close()
    del eng, index
    release_device_memory()

    # -- IVFPQ with OPQ ------------------------------------------------------
    eng = main_engine({"opq": True})
    opq = ingest_and_build(eng, base)
    index = eng.indexes["emb"]
    R = index._opq_R
    opq.update(opq_iters=index.opq_iters,
               recon_error=index.reconstruction_error(),
               recon_error_without=ivfpq["recon_error"],
               build_s_without=ivfpq["build_s"],
               orthonormality=float(np.abs(R.T @ R - np.eye(d)).max()))
    opq["full"], _ = run_path(eng, q, GATED_PARAMS, truth)
    check(opq["full"]["launches"]["int8_blockmax_scan"] > 0,
          "the OPQ full scan never launched the block-max kernel")
    t0 = time.monotonic()
    index._publish()
    torch.cuda.synchronize()
    opq["publish_s"] = time.monotonic() - t0
    opq["probe"], _ = run_path(eng, q, dict(PROBE_PARAMS, **GATED_PARAMS),
                               truth)
    check(opq["probe"]["launches"]["ivf_probe_dots"] > 0,
          "the OPQ probe regime never launched the probe-dots kernel")
    out["ivfpq_opq"] = opq
    print("storage_opq " + json.dumps(opq), flush=True)
    check(opq["orthonormality"] < 1e-4, "OPQ rotation is not orthonormal")
    for regime in ("full", "probe"):
        check(opq[regime]["recall_at_10"] >= 0.95,
              f"OPQ {regime} recall@10 {opq[regime]['recall_at_10']} "
              "< 0.95")
    eng.close()
    del eng, index
    release_device_memory()

    # -- IVFRABITQ with an int4 stage-1 tier ----------------------------------
    eng = family_engine("IVFRABITQ", "L2", {
        "ncentroids": 2048, "nprobe": 64, "train_iters": 8,
        "training_threshold": 2 * n, "store_dtype": "bfloat16",
        "mirror_dtype": "int4"})
    rabitq = ingest_and_build(eng, base)
    counts0 = bs.refine_search_counts()
    rabitq["three_stage"], _ = run_path(eng, q, {"rerank": 256}, truth)
    rabitq["refine_search_counts"] = {
        k: v - counts0[k] for k, v in bs.refine_search_counts().items()}
    check(rabitq["three_stage"]["tags"] == ["binary_refine_rerank"],
          f"IVFRABITQ int4 tags {rabitq['three_stage']['tags']}")
    out["ivfrabitq_int4"] = rabitq
    print("storage_rabitq_int4 " + json.dumps(rabitq), flush=True)
    check(rabitq["three_stage"]["recall_at_10"] >= 0.95,
          f"IVFRABITQ int4 recall@10 "
          f"{rabitq['three_stage']['recall_at_10']} < 0.95 at rerank 256")
    eng.close()
    del eng
    release_device_memory()
    paths = {"storage": {
        "int4_rerank128": int4["rerank128"],
        "int4_rerank512": int4["rerank512"],
        "opq_full": opq["full"], "opq_probe": opq["probe"],
        "ivfrabitq_int4": rabitq["three_stage"]}}
    return out, paths


# -- phase 9: the cluster plane ------------------------------------------------

CLUSTER_BATCH = 5_000  # docs a router upsert
CLUSTER_B1 = 60  # B=1 searches behind the REST latency's p50 / p99
CLUSTER_FILTER = {"operator": "AND", "conditions": [
    {"field": "cat", "operator": "<", "value": 10}]}
CLUSTER_WRITES = 10_000  # docs the concurrent writer re-upserts
# the gated full scan, selecting by block maxima as the main path's 1M
# rows do under "auto" (REDUCED["cluster"])
CLUSTER_GATED = dict(GATED_PARAMS, topk_mode="blockmax")
CLUSTER_REQUESTS = {
    "full_rerank512": CLUSTER_GATED,
    "full_rerank128": BENCH_PARAMS,
    "probe_rerank512": dict(PROBE_PARAMS, **GATED_PARAMS),
}


def cluster_space(d=128) -> dict:
    """The main path's index at full width behind 2 partitions x 3
    replicas, with one scalar field for a filtered search."""
    params = {"ncentroids": 2048, "nsubvector": 32, "train_iters": 8,
              "training_threshold": 10 ** 9, "store_dtype": "bfloat16"}
    return {"name": "s", "partition_num": 2, "replica_num": 3, "fields": [
        {"name": "emb", "data_type": "vector", "dimension": d,
         "index": {"index_type": "IVFPQ", "metric_type": "L2",
                   "params": params}},
        {"name": "cat", "data_type": "integer", "scalar_index": "INVERTED"},
    ]}


def router_search(cl, queries, params, **kw):
    """One search through the router: (ids [B][k] as row numbers, wall
    ms). B > 1 rides the columnar wire (scores as one f32 buffer)."""
    if len(queries) > 1:
        kw.update(fields=[], columnar=True)
    t0 = time.monotonic()
    out = cl.search("db", "s", [{"field": "emb", "feature": queries}],
                    limit=10, index_params=params, cache=False, **kw)
    ms = (time.monotonic() - t0) * 1e3
    return [[int(h["_id"][1:]) for h in row] for row in out], ms


def cluster_recall(ids, truth) -> float:
    return sum(len(set(g) & set(t.tolist()))
               for g, t in zip(ids, truth)) / truth.size


def cluster_path(cl, queries, params, truth, kernel, **kw) -> tuple:
    """A warm-up, then 3 searches through the router (the median's ms),
    with the kernels' launches set to 0 just before the measured
    searches and read just after; `kernel` must have launched."""
    router_search(cl, queries, params, **kw)
    reset_launches()
    times = []
    for _ in range(3):
        ids, ms = router_search(cl, queries, params, **kw)
        times.append(ms)
    out = {"params": params, "B": len(queries),
           "search_ms": float(np.median(times)), "all_ms": times,
           "recall_at_10": cluster_recall(ids, truth),
           "launches": read_launches()}
    check(out["launches"][kernel] > 0,
          f"cluster path {params} never launched {kernel}")
    return out, ids


def cluster_engine_alone(base, cats, queries, truth) -> dict:
    """The same rows, index and requests on one Engine, no cluster: the
    yardstick for the router's and the partition servers' overhead."""
    from vearch_tpu_torch.engine.engine import Engine
    from vearch_tpu_torch.engine.types import TableSchema

    eng = Engine(TableSchema.from_dict(cluster_space(base.shape[1])))
    for i in range(0, len(base), 100_000):
        eng.upsert([{"_id": f"d{j}", "emb": base[j], "cat": int(cats[j])}
                    for j in range(i, min(i + 100_000, len(base)))])
    eng.build_index()
    out = {}
    for name, params in CLUSTER_REQUESTS.items():
        req = engine_request(queries, params)
        eng.search(req)
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            res = eng.search(req)
            times.append((time.monotonic() - t0) * 1e3)
        out[name] = {"search_ms": float(np.median(times)),
                     "recall_at_10": recall_at_10(res, truth)}
    b1 = []
    req = engine_request(queries[:1], CLUSTER_GATED, raw_results=False)
    eng.search(req)
    for i in range(CLUSTER_B1):
        t0 = time.monotonic()
        eng.search(engine_request(queries[i:i + 1], CLUSTER_GATED,
                                  raw_results=False))
        b1.append((time.monotonic() - t0) * 1e3)
    out["b1_p50_ms"] = float(np.percentile(b1, 50))
    out["b1_p99_ms"] = float(np.percentile(b1, 99))
    eng.close()
    del eng
    release_device_memory()
    return out


def cluster_counts(c) -> dict:
    """Each partition's doc count on each of its replicas (node id ->
    count)."""
    out = {}
    for ps in c.ps_nodes:
        for pid, eng in list(ps.engines.items()):
            out.setdefault(str(pid), {})[str(ps.node_id)] = eng.doc_count
    return out


def cluster_build(c, cl) -> dict:
    """Every replica builds its own index: the leaders through the
    router's build route (/index/forcemerge, one partition server each,
    at once), then each follower through its partition server's
    /ps/index/build, one at a time. Seconds of each step."""
    from vearch_tpu_torch.cluster import rpc

    sp = cl.get_space("db", "s")
    leaders = {p["id"]: p["leader"] for p in sp["partitions"]}
    t0 = time.monotonic()
    rpc.call(c.router_addr, "POST", "/index/forcemerge",
             {"db_name": "db", "space_name": "s"}, timeout=900.0)
    out = {"leaders_s": time.monotonic() - t0, "followers_s": []}
    for ps in c.ps_nodes:
        for pid in sorted(ps.engines):
            if leaders[pid] != ps.node_id:
                t1 = time.monotonic()
                rpc.call(ps.addr, "POST", "/ps/index/build",
                         {"partition_id": pid}, timeout=900.0)
                out["followers_s"].append(time.monotonic() - t1)
    out["total_s"] = time.monotonic() - t0
    for ps in c.ps_nodes:
        for pid, eng in ps.engines.items():
            check(int(eng.status) == 3 and eng.indexes["emb"].trained,
                  f"partition {pid} on node {ps.node_id} not built")
    return out


def cluster_concurrent_writer(c, cl, rows, cats, queries, truth) -> dict:
    """Gated searches through the router, one after another, while a
    second client re-upserts CLUSTER_WRITES existing docs (the same
    vectors and fields, 500 a request) through it: the raft apply
    threads, the refresh loops' absorbs and the search threads share the
    engines on one card. Recall must hold in every search and every
    replica must still count the same docs."""
    import threading

    from vearch_tpu_torch.sdk.client import VearchClient

    errors: list = []
    writes = min(CLUSTER_WRITES, len(rows) // 500 * 500)

    def writer():
        wc = VearchClient(c.router_addr)
        try:
            for lo in range(0, writes, 500):
                wc.upsert("db", "s", [{"_id": f"d{i}", "emb": rows[i],
                                       "cat": int(cats[i])}
                                      for i in range(lo, lo + 500)])
        except Exception as e:  # reported and failed below
            errors.append(repr(e))

    router_search(cl, queries, CLUSTER_GATED)
    reset_launches()
    t = threading.Thread(target=writer, name="cluster-writer", daemon=True)
    t0 = time.monotonic()
    t.start()
    times, recalls = [], []
    while t.is_alive() or not times:
        ids, ms = router_search(cl, queries, CLUSTER_GATED)
        times.append(ms)
        recalls.append(cluster_recall(ids, truth))
    t.join()
    res = {"params": CLUSTER_GATED, "B": len(queries),
           "searches": len(times), "search_ms": float(np.median(times)),
           "all_ms": times, "recall_at_10": min(recalls),
           "launches": read_launches()}
    writes_s = time.monotonic() - t0
    counts = cluster_counts(c)
    out = {"rewritten_docs": writes, "writes_s": writes_s,
           "search": res, "doc_counts": counts}
    check(not errors, f"concurrent writer failed: {errors}")
    check(res["launches"]["int8_blockmax_scan"] > 0,
          "searches under a writer never launched the block-max kernel")
    check(res["recall_at_10"] >= 0.95,
          f"recall@10 under a writer {res['recall_at_10']} < 0.95")
    check(all(len(set(r.values())) == 1 for r in counts.values())
          and sum(next(iter(r.values())) for r in counts.values())
          == len(rows), f"doc counts under a writer {counts}")
    return out


def cluster_failover(c, cl, queries, truth, before) -> dict:
    """Stop the partition server that leads partition 0, wait (with a
    deadline) until the master names another leader, then search again
    at rerank 512 through the promoted leader."""
    sp = cl.get_space("db", "s")["partitions"]
    part0 = min(sp, key=lambda p: p["id"])
    dead = part0["leader"]
    victim = next(ps for ps in c.ps_nodes if ps.node_id == dead)
    t0 = time.monotonic()
    victim.stop(flush=False)
    deadline = t0 + 120.0
    leader = dead
    while time.monotonic() < deadline:
        parts = cl.get_space("db", "s")["partitions"]
        leader = next(p for p in parts if p["id"] == part0["id"])["leader"]
        if leader not in (dead, -1):
            break
        time.sleep(0.1)
    promoted_s = time.monotonic() - t0
    check(leader not in (dead, -1),
          f"no new leader for partition {part0['id']} within 120 s")
    while True:  # the router's view of the new leader, with a deadline
        try:
            router_search(cl, queries[:1], CLUSTER_GATED)
            break
        except Exception:
            check(time.monotonic() < deadline,
                  "no search served after the failover within 120 s")
            time.sleep(0.1)
    serving_s = time.monotonic() - t0
    res, ids = cluster_path(cl, queries, CLUSTER_GATED, truth,
                            "int8_blockmax_scan")
    diff = sum(a != b for a, b in zip(ids, before))
    out = {"partition": part0["id"], "stopped_node": dead,
           "new_leader": leader, "leader_promoted_s": promoted_s,
           "first_search_served_s": serving_s, "search": res,
           "ids_equal_before": diff == 0, "rows_differing": diff}
    check(res["recall_at_10"] >= 0.95,
          f"recall@10 after failover {res['recall_at_10']} < 0.95")
    return out


def phase_cluster(dev, base, queries) -> tuple[dict, dict]:
    """The port's cluster plane on the card: StandaloneCluster (master,
    router, 3 partition servers, no device argument: the card), driven
    through the port's SDK."""
    from vearch_tpu_torch.cluster.standalone import StandaloneCluster
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.sdk.client import VearchClient

    n = CLUSTER_ROWS
    rows = base[:n]
    cats = engine_docs(rows, seed=12)[0]
    truth = exact_topk(dev, queries, rows, MetricType.L2)
    times, out, paths = {}, {"rows": n, "reduced": REDUCED["cluster"]}, {}
    t0 = time.monotonic()
    alone = cluster_engine_alone(rows, cats, queries, truth)
    out["engine_alone"] = alone
    times["engine_alone"] = time.monotonic() - t0
    print("cluster_engine_alone " + json.dumps(alone), flush=True)

    data_dir = tempfile.mkdtemp(prefix="vearch_chip_cluster_")
    c = StandaloneCluster(data_dir=data_dir, n_ps=3,
                          ps_kwargs={"heartbeat_interval": 0.3})
    try:
        t0 = time.monotonic()
        c.start()
        for ps in c.ps_nodes:
            check(ps.device.type == "cuda",
                  "a partition server did not default to cuda")
        cl = VearchClient(c.router_addr)
        cl.create_database("db")
        cl.create_space("db", cluster_space(base.shape[1]))
        times["start"] = time.monotonic() - t0
        # the SDK sends vectors as JSON lists: every raft entry is logged
        # as JSON, so ndarray leaves cannot reach the partition servers
        t0 = time.monotonic()
        for i in range(0, n, CLUSTER_BATCH):
            hi = min(i + CLUSTER_BATCH, n)
            cl.upsert("db", "s", [{"_id": f"d{j}", "emb": rows[j],
                                   "cat": int(cats[j])}
                                  for j in range(i, hi)])
            if hi % 100_000 == 0:
                print(f"cluster: {hi} docs in "
                      f"{time.monotonic() - t0:.1f}s", flush=True)
        times["ingest"] = time.monotonic() - t0
        out["ingest_docs_per_s"] = n / times["ingest"]
        counts = cluster_counts(c)
        out["doc_counts"] = counts
        check(len(counts) == 2 and all(len(r) == 3 for r in counts.values()),
              f"replicas {counts}")
        check(all(len(set(r.values())) == 1 for r in counts.values()),
              f"replicas disagree on doc counts {counts}")
        check(sum(next(iter(r.values())) for r in counts.values()) == n,
              f"partition doc counts {counts} do not sum to {n}")
        print(f"cluster: ingest {times['ingest']:.1f}s "
              f"({out['ingest_docs_per_s']:.0f} docs/s) counts "
              + json.dumps(counts), flush=True)
        t0 = time.monotonic()
        out["build"] = cluster_build(c, cl)
        times["build"] = time.monotonic() - t0
        print("cluster_build " + json.dumps(out["build"]), flush=True)

        t0 = time.monotonic()
        kernels = {"full_rerank512": "int8_blockmax_scan",
                   "full_rerank128": "int8_blockmax_scan",
                   "probe_rerank512": "ivf_probe_dots"}
        searches = {}
        for name, params in CLUSTER_REQUESTS.items():
            res, ids = cluster_path(cl, queries, params, truth,
                                    kernels[name])
            res["engine_alone_ms"] = alone[name]["search_ms"]
            searches[name] = res
            paths[name] = res
            if name == "full_rerank512":
                before = ids
            print(f"cluster_search {name} " + json.dumps(res), flush=True)
        check(searches["full_rerank512"]["recall_at_10"] >= 0.95,
              "cluster recall@10 at rerank 512 "
              f"{searches['full_rerank512']['recall_at_10']} < 0.95")
        valid = cats < 10
        ftruth = exact_topk(dev, queries, rows, MetricType.L2, valid=valid)
        res, ids = cluster_path(cl, queries, CLUSTER_GATED, ftruth,
                                "int8_blockmax_scan",
                                filters=CLUSTER_FILTER)
        check(all(len(r) == 10 and bool(valid[r].all()) for r in ids),
              "a filtered search returned a short row or a failing doc")
        check(res["recall_at_10"] >= 0.95,
              f"filtered recall@10 {res['recall_at_10']} < 0.95")
        searches["filtered_cat_lt_10"] = paths["filtered"] = res
        print("cluster_search filtered " + json.dumps(res), flush=True)
        # B=1: the latency a REST user feels (item dicts, not columnar)
        router_search(cl, queries[:1], CLUSTER_GATED)
        reset_launches()
        b1 = [router_search(cl, queries[i:i + 1], CLUSTER_GATED)[1]
              for i in range(CLUSTER_B1)]
        searches["b1"] = paths["b1"] = {
            "params": CLUSTER_GATED, "searches": CLUSTER_B1,
            "p50_ms": float(np.percentile(b1, 50)),
            "p99_ms": float(np.percentile(b1, 99)),
            "engine_alone_p50_ms": alone["b1_p50_ms"],
            "engine_alone_p99_ms": alone["b1_p99_ms"],
            "launches": read_launches()}
        check(searches["b1"]["launches"]["int8_blockmax_scan"] > 0,
              "B=1 searches never launched the block-max kernel")
        # the split of one gated search into router, partition servers
        # and engines (profile: true), with every engine's rows on the card
        t1 = time.monotonic()
        prof = cl.search("db", "s", [{"field": "emb", "feature": queries}],
                         limit=10, index_params=CLUSTER_GATED, cache=False,
                         profile=True)
        prof = dict(prof["profile"],
                    wall_ms=(time.monotonic() - t1) * 1e3)
        searches["profile_rerank512"] = prof
        print("cluster_profile " + json.dumps(prof), flush=True)
        out["searches"] = searches
        # each server's sampler holds the card's process-wide allocated
        # bytes against its own engines' footprint models only
        out["sampler"] = {str(ps.node_id): ps.device_sampler.sample_now()
                          for ps in c.ps_nodes}
        print("cluster_sampler " + json.dumps(out["sampler"]), flush=True)
        out["concurrent_writer"] = cw = cluster_concurrent_writer(
            c, cl, rows, cats, queries, truth)
        paths["concurrent_writer"] = cw["search"]
        print("cluster_writer " + json.dumps(cw), flush=True)
        times["searches"] = time.monotonic() - t0

        t0 = time.monotonic()
        out["failover"] = fo = cluster_failover(c, cl, queries, truth, before)
        paths["failover"] = fo["search"]
        times["failover"] = time.monotonic() - t0
        print("cluster_failover " + json.dumps(fo), flush=True)
    finally:
        t0 = time.monotonic()
        c.stop()
        shutil.rmtree(data_dir, ignore_errors=True)
        del c
        release_device_memory()
        times["stop"] = time.monotonic() - t0
    out["seconds"] = times
    return out, paths


def profile_search(eng, req, ranges=()) -> dict:
    """Device time by kernel over one search (torch.profiler), the
    device's busy share of the search's wall time, and the device time
    under each named `ranges` (record_function) of the search."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.search(req)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        # a record_function range shows on the device too: not a kernel
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us
                and ev.key not in ranges):
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    res = {"wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms if wall_ms else 0.0,
           "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                   for ms, k, c in rows[:8]]}
    if ranges:
        got = {ev.key: getattr(ev, "device_time_total", 0.0) / 1e3
               for ev in prof.key_averages() if ev.key in ranges}
        res["ranges_ms"] = {name: got.get(name, 0.0) for name in ranges}
    print("profile " + json.dumps(res), flush=True)
    return res


def launches_by_path(main_res, family, kernel) -> dict:
    """A kernel's launches on each path of this run, each path's count
    set to 0 just before it ran and read just after."""
    out = {"ivfpq_full": main_res["launches"][kernel],
           "ivfpq_probe": main_res["probe"]["launches"][kernel]}
    for name, sub in family.items():
        if isinstance(sub, dict):
            for path, res in sub.items():
                if isinstance(res, dict) and "launches" in res:
                    out[f"{name}.{path}"] = res["launches"][kernel]
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    return {"int8_blockmax_scan": bms.int8_blockmax_stage1,
            "ivf_probe_dots": pd.ivf_probe_dots}


def reset_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def build_all() -> None:
    """Build every kernel library (one nvcc per source), the host HNSW
    graph and the cluster plane's host loops (g++), all at once."""
    from vearch_tpu_torch import native
    from vearch_tpu_torch.native import hnsw_graph
    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops import probe_dots as pd

    kernels = (bms.LIBRARY, pd.LIBRARY)
    libs = (*kernels, hnsw_graph.LIBRARY, native.LIBRARY)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs]:
            fut.result()
    print(f"build: {time.monotonic() - t0:.2f}s", flush=True)
    for lib in libs:
        print(lib.build_log, flush=True)
    for lib in kernels:
        print(f"sass {lib.source.name}: " + json.dumps(sass_counts(lib)),
              flush=True)


def sass_counts(lib) -> dict:
    """Tensor-core instructions in a built library's SASS (cuobjdump):
    HGMMA is Hopper's warpgroup product, HMMA the warp-level one."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return {"cuobjdump": "not found"}
    out = subprocess.run([tool, "-sass", lib.path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    return {op: len(re.findall(rf"\b{op}\b", out.stdout))
            for op in ("HGMMA", "HMMA", "FFMA")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from vearch_tpu_torch.ops.ivf import coarse_dots, select_probes

    from vearch_tpu_torch.obs import flight_recorder

    dev = torch.device("cuda")
    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # the flight recorder hears every compile event (library builds, new
    # launch shapes); this run also keeps each one, to print them
    recorder = flight_recorder.install()
    events: list = []

    def observe(program, sig, ms):
        events.append({"program": program, "signature": sig, "ms": ms,
                       "in_warmup": recorder.in_warmup()})
        recorder.on_compile(program, sig, ms)

    perf_model.set_compile_observer(observe)
    with recorder.warmup():  # the builds at start are expected
        build_all()
    print("build_events " + json.dumps(
        [e for e in events if e["program"].startswith("build.")]),
        flush=True)

    t0 = time.monotonic()
    base, queries = build_data()
    print(f"data: {time.monotonic() - t0:.1f}s", flush=True)
    # the HNSW graph (host C++, single-threaded) builds on its own thread
    # while the card works; phase_family reads it last
    disk_tmp = tempfile.mkdtemp(prefix="vearch_chip_disk_")
    graph_pool = ThreadPoolExecutor(2)
    graph_build = graph_pool.submit(build_graph_engine, base[:GRAPH_ROWS])
    disk_graph_build = graph_pool.submit(
        build_disk_graph_engine, base[:GRAPH_ROWS],
        os.path.join(disk_tmp, "hnsw"))

    t0 = time.monotonic()
    phase_kernels(dev)
    phase_probe_kernels(dev)
    phase_blockmax_exact(dev)
    print(f"phase kernels: {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    main_res, truth, (a8, sc, vs), valid, index = phase_main(
        dev, base, queries)
    print("main_path " + json.dumps(main_res), flush=True)
    print(f"phase main: {time.monotonic() - t0:.1f}s", flush=True)
    for b in (64, 1024):
        q = torch.from_numpy(queries[:b]).to(dev)
        res = compare_case(f"main_B{b}", q, a8, sc, vs, valid, 128, True)
        probes = select_probes(coarse_dots(q, index.centroids),
                               index.centroids, PROBE_PARAMS["nprobe"])
        pres = compare_probe_case(f"main_B{b}", q,
                                  probes.to(torch.int32).contiguous(),
                                  index._bucket_resid8, index._bucket_lens,
                                  breakdown=True)
    del index, a8, sc, vs, valid, q, probes
    release_device_memory()
    t0 = time.monotonic()
    engine, engine_paths = phase_engine(dev, base, queries)
    print("engine " + json.dumps(engine), flush=True)
    print(f"phase engine: {time.monotonic() - t0:.1f}s", flush=True)
    try:
        t0 = time.monotonic()
        family = phase_family(dev, base, queries, truth, graph_build)
        print("family " + json.dumps(family), flush=True)
        print(f"phase family: {time.monotonic() - t0:.1f}s", flush=True)
        t0 = time.monotonic()
        disk, disk_paths = phase_disk(dev, base, queries, truth, disk_tmp,
                                      disk_graph_build)
        print("disk " + json.dumps(disk), flush=True)
        print(f"phase disk: {time.monotonic() - t0:.1f}s", flush=True)
    finally:
        graph_pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(disk_tmp, ignore_errors=True)
    t0 = time.monotonic()
    runtime, runtime_paths = phase_runtime(dev, base, queries, events)
    print("runtime " + json.dumps(runtime), flush=True)
    print(f"phase runtime: {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    storage, storage_paths = phase_storage_modes(dev, base, queries, truth,
                                                 runtime["ivfpq"])
    print("storage " + json.dumps(storage), flush=True)
    print(f"phase storage_modes: {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    cluster, cluster_paths = phase_cluster(dev, base, queries)
    print("cluster " + json.dumps(cluster), flush=True)
    print(f"phase cluster: {time.monotonic() - t0:.1f}s", flush=True)
    footprint_table()
    paths = dict(family, engine=engine_paths, **disk_paths, **runtime_paths,
                 **storage_paths, cluster=cluster_paths)
    dres = disk["kernel_case"]
    kernels = [
        {"name": "int8_blockmax_scan", "route": "cuda",
         "design": "wgmma bf16 (A: int8 rows converted in registers, B: "
                   "the query tile in shared memory), persistent CTAs, "
                   "fused block-max epilogue",
         "source": "vearch_tpu_torch/csrc/blockmax_scan.cu",
         "replaces": "vearch_tpu/ops/pallas_kernels.py:201",
         "launches": main_res["launches"]["int8_blockmax_scan"],
         "launches_by_path": launches_by_path(
             main_res, paths, "int8_blockmax_scan"),
         "max_abs_err": res["bmax_max_abs_err"], "ms": res["kernel_ms"],
         "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": res["library_ms"]},
        {"name": "ivf_probe_dots", "route": "cuda",
         "design": "pairs sorted by bucket on the device; a CTA per "
                   "(bucket, 64-row tile) reads its live rows once per 64 "
                   "pairs, mma.sync bf16 (int8 rows converted in "
                   "registers), zero tails as 16-byte stores",
         "source": "vearch_tpu_torch/csrc/probe_dots.cu",
         "replaces": "vearch_tpu/ops/pallas_kernels.py:54",
         "launches": main_res["probe"]["launches"]["ivf_probe_dots"],
         "launches_by_path": launches_by_path(
             main_res, paths, "ivf_probe_dots"),
         "max_abs_err": pres["max_abs_err"], "ms": pres["kernel_ms"],
         "plain_ms": pres["plain_ms"], "bound_ms": pres["bound_ms"],
         "bound_by": pres["bound_by"], "library_ms": pres["library_ms"],
         # the DISKANN path's shape: the resident slab pool as buckets
         "disk_case": {k: dres[k] for k in (
             "B", "nprobe", "nlist", "cap", "max_abs_err", "kernel_ms",
             "plain_ms", "library_ms", "bound_ms", "bound_by")}},
    ]
    print("quoted_previous_ms (PERF.md section 6, not measured in this "
          "run) " + json.dumps(QUOTED_PREVIOUS_MS), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
