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
     boundary); stage 2 from the same maxima (`compare_stage2`, also over
     `stage2_cases`): every re-scored entry within its f32 bound of the
     exact score, top-r ids equal to the plain stage 2's except at score
     ties, one launch of its kernel a call, and its times (the kernel
     alone, the whole stage, the top-r, the plain stage, the plain
     gather + widen + bmm as the library yardstick, the bound, the share
     of (query tile, block) pairs computed, the peak bytes);
   - both block-max stages at d=960 (`wide_cases`, B=1024 and 64: the
     64-query tile, a 15-step K loop), as above for queries apart from
     the rows; next to a row stage 1 is held to exact float64 maxima
     (`compare_stage1_exact`); then at the gist1m-ivfpq.batch-full
     cell's own shape (1,000,448 x 960, B=1024, rerank 512;
     `phase_wide_kernels`): one launch of each kernel a full scan,
     stage 1 within one bf16 ulp of the plain version, stage 2's ids at
     B=64, and both stages' times beside the plain ones and the bound
     (the `d960_case` of each block-max row of the kernel table);
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
3b. The mesh layer (`phase_mesh`), at the main path's rows and settings,
   B=1024, with 4 virtual shards on the one card (REDUCED["mesh"]):
   one IVFPQ engine served single-device, through a 1x1 mesh and
   through a 4x1 mesh (per request: `mesh_serving: "on"`, `mesh_shape`),
   in the full scan (rerank 512, topk_mode "blockmax": the block-max
   kernel must launch once a search per shard) and the probe regime
   (nprobe 64, rerank 512: the gated mirror scan, plain PyTorch);
   recall@10 >= 0.95 on every path, the 1x1 full scan's ids equal to
   the single device's, the other paths' differing rows counted; FLAT
   against FLAT_SHARDED over the 4x1 mesh (scores equal within
   SCORE_TOL); `mesh_train` over the 4x1 mesh against the unsharded
   build (k-means objective within 2%, recall within 0.01); IVFRABITQ
   single-device and over both meshes.
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
     model), and allocated - baseline - the process's counted cuBLAS
     workspaces - model must lie in [0, UNMODELLED_BOUND_BYTES] for every
     one (both sides: a model that over-counts fails too);
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
   probe-dots kernel. phase_elastic then runs on this cluster, and the
   cluster stops and the card is emptied.
10. Elastic jobs (`phase_elastic`), on phase_cluster's cluster after its
   failover: a fresh partition server joins and the master re-places the
   replicas the failover dropped on it (caught up by raft log replay;
   the counts of the cluster's space equal on 3 replicas again), a space
   of ELASTIC_ROWS docs (1 partition x 3 replicas, REDUCED["elastic"]) is
   built and searched, its partition splits while a bounded writer adds
   ELASTIC_WRITES new docs (doc counts on every replica equal the seeds
   plus the acked writes, every child engine on the card), the children
   are built and searched (the block-max kernel on the full scan, probe
   dots on the probe regime, recall@10 >= 0.95), a child's replica
   migrates to a second fresh server and the first is drained, which
   moves the re-placed replicas of the cluster's space too (counts held
   on every replica of both spaces; the moved replicas, which arrive
   unindexed as the reference's do, are built; recall held on both
   spaces and both kernels launching again), the port's lint CLI, run
   over the checkout's vearch_tpu_torch/ in its own process while the
   jobs run, prints its summary line, then its seconds beside the card's
   name and power limit (a finding fails the run), and the cluster
   doctor runs (its exit code and checks printed; any
   violation outside DOCTOR_EXPECTED fails the run, and so does a
   `lint_clean` check that is skipped or not ok).
11. The roles as processes (`phase_processes`), after phase_cluster's
   cluster stopped and the card was emptied. First the census of one
   partition server alone on the card (`census_main`, in a process of
   its own, with the allocator's memory history): PROCESS_ROWS rows of
   phase_cluster's space, its build, 8 client threads searching beside
   a writer; every live block attributed to the stack that allocated it;
   the server's sampler must report no drift with the threads' cuBLAS
   workspaces counted, and torch._C._cuda_clearCublasWorkspaces() must
   free exactly the workspace bytes it counted (read block by block from
   allocator snapshots on either side of it, by each block's requested
   size: the allocator may hand a workspace a larger cached block whole;
   a block the server's own threads free in that moment is named apart,
   not counted). Then
   cloud/smoke_torch.py's topology, 3 masters (metadata raft), 2 routers
   (each with a gRPC port where grpcio and protobuf are importable) and
   3 partition servers, each `python -m vearch_tpu_torch` in its own
   process, the servers without `--device` (so on the card; one that
   cannot reach it fails the phase). phase_cluster's space and
   PROCESS_ROWS rows,
   upserted through both routers at once; every replica built; each
   server's /metrics must show live bytes under a cuda label and the
   card must list at least 3 new contexts (nvidia-smi); the full scan at
   rerank 512 and 128, the probe regime and 60 B=1 searches through the
   routers (recall@10 >= 0.95 at rerank 512; rows differing from
   phase_cluster's ids counted), whose dispatch tags (profile: true)
   must be phase_cluster's (the launch counters live in the children);
   gated searches through one router while the other re-upserts
   CLUSTER_WRITES docs; through each router's gRPC port the gated full
   scan beside the same request over REST (ids equal, the ms of each,
   the dispatch tags its traces left on the servers equal to REST's),
   and an upsert, search, query and delete of GRPC_DOCS new docs (or
   the line names the missing package); a LangChain and a LlamaIndex
   store from vearch_tpu_torch.sdk.integrations over router1, each
   adding INTEGRATION_TEXTS texts with a seeded toy embedding (every
   probed text its own top hit, a second store on the existing space,
   deletes by id and by source document honoured); kill -9 of partition
   0's leader while a writer
   adds PROCESS_FAILOVER_WRITES new docs (leader, write and search
   seconds; every acked id read back by a query by ids; recall@10 >=
   0.95 after); the killed server restarted on its data dir (WAL
   replay, catch-up until 3 replicas count the same); kill -9 of the
   metadata leader (both routers serve, a new leader within a
   deadline); an S3 round trip of a PROCESS_S3_ROWS-doc space against
   the smoke's MockS3 (backup, delete all, restore: every replica counts
   them again and a rerank-512 search returns the same ids); the
   doctor as its own process (violations within DOCTOR_EXPECTED but for
   `hbm_drift`, which a server alone in its process must not show;
   `lint_clean` ok). Every child is killed in a `finally`, and on a
   failure the tail of each child's log is printed.

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
HNSWQ_ROWS = 100_000  # IVFPQ + HNSW coarse quantizer, reduced
FLAT_DISK_B = 64  # queries of the streaming FLAT scan on a disk store
CLUSTER_ROWS = 20_000  # rows served by phase_cluster, reduced
CLUSTER_WRITES = 5_000  # docs the concurrent writer re-upserts, reduced
PROCESS_ROWS = 20_000  # rows served by phase_processes, reduced
# phase_family's and phase_disk's cuts of scale, each with its reason
REDUCED = {
    "hnsw_graph": f"{GRAPH_ROWS} rows, {GRAPH_B} queries: the graph is "
                  "single-threaded host C++ whose 1M-row build would take "
                  "most of the run's time limit",
    "ivfpq_hnsw_quantizer": f"{HNSWQ_ROWS} rows and 1024 centroids "
                            "(half of scripts/benchmarks/per_index.py's "
                            "200,000 rows, cut when the whole run took "
                            "1,145 s of its 1,200 s on a slow host): "
                            "absorb assigns every row by a host graph walk",
    "flat_disk": f"{FLAT_DISK_B} queries: the exact scan streams all 1M "
                 "rows through the card in 262,144-row chunks per batch",
    "hnsw_disk": f"{GRAPH_ROWS} rows, {GRAPH_B} queries, as hnsw_graph: "
                 "the graph that auto picks on a disk store is the same "
                 "single-threaded host build",
    "cluster": f"{CLUSTER_ROWS} rows (the main path's first), 2 "
               "partitions x 3 replicas: every doc crosses the router and the "
               "raft log of 3 replicas as JSON on one Python process "
               "(824-1259 docs/s on the chip machine's hosts; this run's "
               "rate, and the seconds it projects for 1M rows, follow), "
               "so a 1M-row ingest does not fit the run's time limit, and "
               "the run, which stood at 1,023-1,120 s of its 1,200 s at "
               "200,000 rows and 1,084 s at 100,000, gives "
               "phase_processes the ingest time this cut saves (at "
               "100,000 rows first, then at 50,000 for its census of one "
               "server, its gRPC and its framework-integration steps, "
               "then at 30,000 when the whole run took 1,131 s of its "
               "1,200 s on a slower host, and at 20,000, phase_processes' "
               "rows, when it took 1,145 s at 30,000; PERF.md section 6). "
               f"Its writer re-upserts {CLUSTER_WRITES:,} of them (10,000 "
               "before: at 20,000 rows that left a third of each "
               "partition's slots deleted, past the doctor's retrain "
               "hint at 0.3; 5,000 leaves 0.2, between the 0.17 and 0.25 "
               "of the runs at 50,000 and 30,000 rows). "
               "Its full scans (rerank 512 and bench.py's 128) name "
               f"topk_mode 'blockmax': at {CLUSTER_ROWS // 2:,} rows a "
               "partition the 'auto' gate (blocks >= 4 x max(32, rerank / 4): 128 "
               "blocks, 65,536 rows, at rerank 128) would select exactly, "
               "where the main path's 1M rows select by block maxima",
    "elastic": "10,000 seed docs (bench.py's recipe at its density of "
               "200 rows a cluster, seed 7, with 1024 queries perturbed "
               "from them) in a space of 1 partition x 3 replicas on "
               "phase_cluster's cluster after its failover, 64 centroids, "
               "nprobe 32, and 1,000 new docs written during the split, "
               "which is the job cut: a split copies every doc through "
               "the children's raft logs as JSON at 764 docs/s on the "
               "card (PERF.md section 6; this run prints its own rate and "
               "the time it projects for one of the cluster's "
               f"{CLUSTER_ROWS // 2:,}-doc partitions), so splitting, "
               "building and moving that partition's children would add "
               "~80-120 s to a run that has no room left for it. The drain "
               f"moves the cluster's own re-placed {CLUSTER_ROWS // 2:,}-doc "
               "replicas at full size (REDUCED['cluster']). The rerank-512 "
               "full scans name topk_mode 'blockmax' as phase_cluster's do",
    "processes": f"{PROCESS_ROWS} rows (the main path's first) in "
                 "phase_cluster's space, with its requests: the roles as "
                 "processes ingest through the same JSON and raft path "
                 "(REDUCED['cluster']), and at phase_cluster's 100,000 "
                 "rows (the same rows, so ids compared row by row) the "
                 "whole run took 1,122 s of its 1,200 s on an H100 host, "
                 "and 1,136 s at 50,000 rows on a slower one (PERF.md "
                 "section 6), so the S3 round trip was cut first (to "
                 "5,000 docs of elastic_data's recipe, 10,000 before) and "
                 "then these rows; 5,000 new docs written across the "
                 "partition leader's kill -9; the census server serves "
                 "the same rows and traffic alone, in a process of its "
                 "own, before the topology starts",
    "mesh": "4 virtual shards on the one card "
            "(parallel/mesh.set_virtual_device_count): the machine has "
            "one card, so the merge across cards is not measured; the "
            "rerank-512 full scans name topk_mode 'blockmax', which "
            "'auto' would turn off at 250,000 rows a shard",
}
# each kernel's B=1024 time before its redesign, quoted from PERF.md
# section 6 (not measured by this script): the CUDA-core block-max
# kernel and the one-block-per-pair probe kernel, on an H100 SXM at 700 W
QUOTED_PREVIOUS_MS = {"int8_blockmax_scan": 10.39, "ivf_probe_dots": 25.36}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def build_data(n=1_000_000, d=128, seed=0, nc=5000):
    """bench.py's data: `nc` (5000) gaussian clusters, 1024 perturbed
    queries."""
    rng = np.random.default_rng(seed)
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


def stage2_cases():
    """Stage-2 cases beyond small_cases(), where the selection prunes
    (nb_sel < nblk) so the kernel skips blocks: one query (the 8-wide
    tile), a batch that no tile width divides, IP, whole blocks masked
    out, and a batch of two ragged 128-wide tiles with every block
    selected (name, arrays, r, l2)."""
    out = []
    base, q8, sc, vs = mirror_case(200 * 512, 128, 31)
    rng = np.random.default_rng(32)
    q = base[rng.choice(200 * 512, 1, replace=False)] + 0.01
    out.append(("b1_prune", q, q8, sc, vs, np.ones(200 * 512, bool), 64,
                True))
    q = base[rng.choice(200 * 512, 77, replace=False)] + 0.1
    out.append(("b77_prune_ip", q, q8, sc, vs, np.ones(200 * 512, bool),
                128, False))
    dead = np.ones(200 * 512, bool).reshape(200, 512)
    dead[::3] = False  # every third block wholly masked
    dead[1::7, ::2] = False
    q = base[rng.choice(200 * 512, 20, replace=False)] + 0.01
    out.append(("dead_blocks", q, q8, sc, vs, dead.reshape(-1), 32, True))
    base, q8, sc, vs = mirror_case(60 * 512, 64, 33)
    q = np.random.default_rng(34).standard_normal((130, 64)).astype(
        np.float32)
    out.append(("b130_all_selected", q, q8, sc, vs, np.ones(60 * 512, bool),
                64, True))
    return out


def wide_cases():
    """GIST1M's row width (d=960) at the benchmark's batch (B=1024) and
    at one 64-wide tile (B=64): a bf16 tile of 128 queries would pass
    the kernels' shared-memory budget, so both stages run 64-query tiles
    and a 15-step K loop; 100 blocks, so stage 2 prunes (72 selected at
    r=64). Queries drawn apart from the rows (as `b70`), whose block
    maxima lie far from 0, and queries next to a row (`_near`), whose
    best block maximum is a small difference of large sums
    (name, arrays, r, l2)."""
    out = []
    base, q8, sc, vs = mirror_case(100 * 512, 960, 41)
    rng = np.random.default_rng(42)
    for b in (1024, 64):
        q = rng.standard_normal((b, 960)).astype(np.float32)
        out.append((f"d960_b{b}", q, q8, sc, vs, np.ones(100 * 512, bool),
                    64, True))
        q = base[rng.choice(100 * 512, b, replace=False)] + 0.01
        out.append((f"d960_b{b}_near", q, q8, sc, vs,
                    np.ones(100 * 512, bool), 64, True))
    return out


def stage1_exact(qb, qsq, a64, sc, vs, va, l2):
    """Exact (float64) block maxima of stage 1 over the mirror (a64: its
    rows as float64) for bf16 queries qb [b, d], and the bound on a
    kernel's maxima from them: each row's f32 score lies within
    stage2_exact's bound of its exact score, so the block's f32 maximum
    lies within the block's largest bound of the exact maximum, and the
    bf16 rounding adds at most one bf16 ulp. Every row valid."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms

    check(bool(va.all()), "stage1_exact takes a mirror with no row masked")
    b = qb.shape[0]
    n_pad = a64.shape[0]
    rows = torch.arange(n_pad, device=qb.device).expand(b, n_pad)
    exact, tol = stage2_exact(qb, qsq, a64, sc, vs, rows, l2)
    ex = exact.view(b, -1, bms.BLOCK).amax(-1)
    return ex, tol.view(b, -1, bms.BLOCK).amax(-1) + bf16_ulp(ex)


def compare_stage1_exact(name, q, a8, sc, vs, va, l2):
    """Stage 1's kernel maxima against the exact maxima (stage1_exact),
    within its bound, 64 queries at a time; the plain version's share of
    the same bound beside it. Returns a result dict; raises where the
    kernel passes its bound."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    qb = q.to(torch.bfloat16).contiguous()
    qsq = sqnorms(q).contiguous()
    args = (qb, a8, sc, vs, va, qsq, l2)
    bk = bms.int8_blockmax_stage1(*args)
    bp = bms.int8_blockmax_stage1_reference(*args)
    a64 = a8.double()
    worst, plain_worst, plain_ulp = 0.0, 0.0, 0.0
    for lo in range(0, q.shape[0], 64):
        hi = min(lo + 64, q.shape[0])
        ex, tol = stage1_exact(qb[lo:hi], qsq[lo:hi], a64, sc, vs, va, l2)
        worst = max(worst, float(((bk[lo:hi].double() - ex).abs()
                                  / tol).max()))
        plain_worst = max(plain_worst, float(
            ((bp[lo:hi].double() - ex).abs() / tol).max()))
        plain_ulp = max(plain_ulp, float(
            ((bk[lo:hi] - bp[lo:hi]).abs() / bf16_ulp(bp[lo:hi])).max()))
    res = {"case": name, "B": q.shape[0], "N_pad": a8.shape[0],
           "d": a8.shape[1], "worst_share_of_bound": worst,
           "plain_worst_share_of_bound": plain_worst,
           "kernel_minus_plain_in_bf16_ulps": plain_ulp}
    print("stage1_exact_case " + json.dumps(res), flush=True)
    check(worst <= 1.0, f"{name}: a block maximum beyond its bound "
          f"({worst:.3f} of it)")
    return res


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
    nb_sel, rr = stage2_select(n_pad, r)
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
    stage2 = compare_stage2(name, q, a8, sc, vs, va, bk, r, l2, timing)
    res = {
        "case": name, "B": b, "N_pad": n_pad, "d": d, "r": r, "l2": l2,
        "stage2": stage2,
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


def stage2_select(n_pad, r):
    """(nb_sel, rr) of a block-max scan over n_pad rows at depth r."""
    nb_sel = perf_model.blockmax_selected_blocks(r, n_pad)
    return nb_sel, min(r, n_pad, nb_sel * perf_model.BLOCK)


def stage2_exact(qb, qsq, a64, sc, vs, rows, l2):
    """Exact (float64) scores of the rows `rows` [b, S] of the mirror
    (a64: its rows as float64) for bf16 queries qb [b, d], and the f32
    bound on a kernel's distance from them: the dot of d exact products
    within 2*d f32 ulps of the sum of their absolute values (any
    summation order; the bound chip_smoke holds the probe kernel to),
    then one rounding of x = dot*scale and, for L2,
    one of |q|^2 - 2x and one of the sum with |v|^2."""
    import torch

    qd = qb.double()
    dots = torch.gather(qd @ a64.T, 1, rows)
    absd = torch.gather(qd.abs() @ a64.abs().T, 1, rows)
    s = sc.double()[rows]
    x = dots * s
    e_acc = 2 * qb.shape[1] * 2 * F32_U * absd * s + F32_U * x.abs()
    if not l2:
        return x, e_acc
    y = qsq.double()[:, None] - 2 * x
    z = y + vs.double()[rows]
    return -z, 2 * e_acc + F32_U * (y.abs() + z.abs())


def compare_stage2(name, q, a8, sc, vs, va, bmax, r, l2, timing=True):
    """The stage-2 kernel against the plain stage 2 on the card, from the
    same stage-1 maxima: every re-scored entry within stage2_exact's f32
    bound of the exact score (-inf exactly where masked), the top-r ids
    equal except at score ties, -1 exactly where the score is not
    finite, one launch of the kernel a call and none of stage 1's.
    Returns a result dict; raises on disagreement."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms, stable_topk

    b, d = q.shape
    n_pad = a8.shape[0]
    nblk = n_pad // bms.BLOCK
    nb_sel, rr = stage2_select(n_pad, r)
    qf = q.float()
    qb, qsq = qf.to(torch.bfloat16).contiguous(), sqnorms(qf).contiguous()
    args = (qf, a8, sc, vs, va, bmax, nb_sel, rr, l2)
    n1, n2 = bms.int8_blockmax_stage1.launches, \
        bms.blockmax_stage2_rescore.launches
    ks, ki = bms.blockmax_stage2(*args)
    check(bms.blockmax_stage2_rescore.launches == n2 + 1,
          f"{name}: stage 2 did not launch its kernel once")
    check(bms.int8_blockmax_stage1.launches == n1,
          f"{name}: stage 2 moved stage 1's launch counter")
    ps, pi = bms.blockmax_stage2_reference(*args)
    _, top = stable_topk(bmax, nb_sel)
    scores = bms.blockmax_stage2_rescore(qb, a8, sc, vs, va, qsq, top, l2)
    torch.cuda.synchronize()
    worst, plain_worst = 0.0, 0.0
    offs = torch.arange(bms.BLOCK, device=q.device)
    a64 = a8.double()
    for lo in range(0, b, 64):
        hi = min(lo + 64, b)
        rows = (top[lo:hi, :, None] * bms.BLOCK + offs).reshape(hi - lo, -1)
        exact, tol = stage2_exact(qb[lo:hi], qsq[lo:hi], a64, sc, vs, rows,
                                  l2)
        ok = va[rows]
        got = scores[lo:hi]
        check(bool(torch.isneginf(got[~ok]).all()),
              f"{name}: a masked row scored above -inf")
        check(bool(torch.isfinite(got[ok]).all()),
              f"{name}: a valid row scored non-finite")
        ratio = ((got.double() - exact).abs() / tol)[ok]
        if ratio.numel():
            worst = max(worst, float(ratio.max()))
        # the plain scores of the same rows, as the reference computes them
        dots = torch.bmm(a8[rows].float(), qb[lo:hi].float()[:, :, None]
                         )[..., 0] * sc[rows]
        plain = -(qsq[lo:hi, None] - 2.0 * dots + vs[rows]) if l2 else dots
        pr = ((plain.double() - exact).abs() / tol)[ok]
        if pr.numel():
            plain_worst = max(plain_worst, float(pr.max()))
    check(worst <= 1.0, f"{name}: a score beyond its f32 bound "
          f"({worst:.3f} of it)")
    fin = torch.isfinite(ks)
    check(torch.equal(fin, torch.isfinite(ps)),
          f"{name}: the finite pattern of the top-r differs")
    check(bool((ki[~fin] == -1).all() and (ki[fin] >= 0).all()),
          f"{name}: ids do not follow the finite scores")
    diff = ki != pi
    tie = diff & torch.isclose(ks, ps, rtol=SCORE_TOL[0], atol=SCORE_TOL[1])
    unexplained = int((diff & ~tie).sum())
    check(unexplained == 0, f"{name}: {unexplained} stage-2 id mismatches "
          f"not explained by a score tie")
    fin_s = fin & (ki == pi)
    _, active = bms.stage2_maps(top, nblk, bms.query_tile(b, d))
    res = {
        "case": name, "B": b, "N_pad": n_pad, "d": d, "nb_sel": nb_sel,
        "rr": rr, "l2": l2, "worst_share_of_bound": worst,
        "plain_worst_share_of_bound": plain_worst,
        "topk_max_abs_diff": float((ks[fin_s] - ps[fin_s]).abs().max())
        if bool(fin_s.any()) else 0.0,
        "id_mismatches": int(diff.sum()), "explained_by_score_tie":
        int(tie.sum()), "unexplained_mismatches": unexplained,
        "tile_block_pairs_computed": float(active.float().mean()),
    }
    if timing:
        res.update(time_stage2(q, a8, sc, vs, va, bmax, top, nb_sel, rr,
                               l2))
    print("stage2_case " + json.dumps(res), flush=True)
    return res


def time_stage2(q, a8, sc, vs, va, bmax, top, nb_sel, rr, l2) -> dict:
    """Stage 2's times on the card: the re-score kernel alone (with its
    maps), the whole of blockmax_stage2 (selection, kernel, top-r), the
    top-r alone, the plain version, and as the library yardstick the
    plain version's gather + widen + f32 bmm (the work the kernel
    replaces); the bound of the kernel's work and the device bytes
    stage 2 allocates at its peak."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    b, d = q.shape
    n_pad = a8.shape[0]
    nblk = n_pad // bms.BLOCK
    s = nb_sel * bms.BLOCK
    qf = q.float()
    qb, qsq = qf.to(torch.bfloat16).contiguous(), sqnorms(qf).contiguous()
    args = (qf, a8, sc, vs, va, bmax, nb_sel, rr, l2)
    out = {"rescore_ms": median_ms(lambda: bms.blockmax_stage2_rescore(
        qb, a8, sc, vs, va, qsq, top, l2))}
    scores = bms.blockmax_stage2_rescore(qb, a8, sc, vs, va, qsq, top, l2)
    out["topk_ms"] = median_ms(lambda: bms.stage2_topk(scores, top, rr))
    del scores
    out["stage2_ms"] = median_ms(lambda: bms.blockmax_stage2(*args))
    out["plain_ms"] = median_ms(
        lambda: bms.blockmax_stage2_reference(*args), reps=3, warm=1)
    words = a8.view(nblk, bms.BLOCK * d).view(torch.int64)
    qbf = qb.float()

    def library():
        for lo in range(0, b, bms.STAGE2_CHUNK):
            blocks = top[lo:lo + bms.STAGE2_CHUNK]
            vecs = torch.index_select(words, 0, blocks.reshape(-1)).view(
                torch.int8).reshape(blocks.shape[0], s, d).float()
            torch.bmm(vecs, qbf[lo:lo + bms.STAGE2_CHUNK, :, None])

    out["library_ms"] = median_ms(library, reps=3, warm=1)
    # the kernel's work: 2 d products a selected (query, row); each input
    # byte once (the rows, scale, |v|^2 and mask of the blocks some query
    # selected, the queries, the maps) and each score written once
    used = int(torch.unique(top).numel()) * bms.BLOCK
    tiles = -(-b // bms.query_tile(b, d))
    flops = 2.0 * d * b * s
    nbytes = (used * (d + 9) + b * (d * 2 + 4) + nblk * b * 4
              + tiles * nblk + b * s * 4)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bms.blockmax_stage2(*args)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def phase_kernels(dev):
    """Both block-max stages against their plain versions over
    small_cases(), stage2_cases() and wide_cases(): the wide cases drawn
    apart from the rows through compare_case (stage 1 within one bf16
    ulp, then compare_stage2), those next to a row (`_near`) through
    compare_stage1_exact and compare_stage2."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms

    out = []
    for name, q, q8, sc, vs, va, r, l2 in (small_cases() + stage2_cases()
                                           + wide_cases()):
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (q.astype(np.float32), q8, sc, vs, va)]
        if not name.endswith("_near"):
            out.append(compare_case(name, *t, r, l2))
            continue
        qf, a8, sc_t, vs_t, va_t = t
        out.append(compare_stage1_exact(name, qf, a8, sc_t, vs_t, va_t, l2))
        bmax = bms.int8_blockmax_stage1(
            qf.to(torch.bfloat16).contiguous(), a8, sc_t, vs_t, va_t,
            sqnorms(qf).contiguous(), l2)
        out.append(compare_stage2(name, qf, a8, sc_t, vs_t, va_t, bmax, r,
                                  l2))
    return out


def phase_wide_kernels(dev, n_pad=1_000_448, d=960, b=1024, r=512,
                       seed=43) -> dict:
    """Both block-max kernels at the gist1m-ivfpq.batch-full cell's own
    shape (a random int8 mirror of n_pad x 960 rows, made on the card,
    1,024 queries apart from the rows, rerank 512): the 64-query tile
    and a 15-step K loop. Checks first: one full scan (int8_blockmax_scan)
    with both launch counters set to 0 just before it must launch each
    kernel once; stage 1's maxima within one bf16 ulp of the plain
    version's; the first 64 queries' top-r ids equal to the plain stage
    2's except at score ties (compare_stage2's full bound check is left
    to wide_cases(), whose rows fit its float64 copies). Then stage 1's
    kernel / plain / library times with its bound from these inputs (and
    the time of the mirror bytes its query tiles stream, at the HBM
    peak), and stage 2's as time_stage2 gives them."""
    import torch

    from vearch_tpu_torch.ops import blockmax_scan as bms
    from vearch_tpu_torch.ops.distance import sqnorms, stable_topk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = torch.randn((n_pad, d), generator=gen, device=dev)
    sc = torch.clamp(base.abs().amax(1) / 127.0, min=1e-12)
    base = torch.clamp(torch.round(base / sc[:, None]), -127, 127)
    vs = ((base * sc[:, None]) ** 2).sum(1)
    a8 = base.to(torch.int8)
    del base
    va = torch.ones(n_pad, dtype=torch.bool, device=dev)
    q = torch.randn((b, d), generator=gen, device=dev)
    qb, qsq = q.to(torch.bfloat16).contiguous(), sqnorms(q).contiguous()
    tile = bms.query_tile(b, d)
    nblk = n_pad // bms.BLOCK
    bms.int8_blockmax_stage1.launches = 0
    bms.blockmax_stage2_rescore.launches = 0
    bms.int8_blockmax_scan(q, a8, sc, vs, va, r)
    torch.cuda.synchronize()
    launches = {"int8_blockmax_scan": bms.int8_blockmax_stage1.launches,
                "blockmax_stage2": bms.blockmax_stage2_rescore.launches}
    check(launches == {"int8_blockmax_scan": 1, "blockmax_stage2": 1},
          f"wide kernels: one full scan launched {launches}")
    args = (qb, a8, sc, vs, va, qsq, True)
    bk = bms.int8_blockmax_stage1(*args)
    bp = bms.int8_blockmax_stage1_reference(*args)
    ulps = float(((bk - bp).abs() / bf16_ulp(bp)).max())
    del bp
    check(ulps <= 1.0, f"wide kernels: a block maximum {ulps} bf16 ulps "
          f"from the plain version's")
    nb_sel, rr = stage2_select(n_pad, r)
    ks, ki = bms.blockmax_stage2(q[:64], a8, sc, vs, va, bk[:64], nb_sel,
                                 rr, True)
    ps, pi = bms.blockmax_stage2_reference(q[:64], a8, sc, vs, va, bk[:64],
                                           nb_sel, rr, True)
    diff = ki != pi
    tie = diff & torch.isclose(ks, ps, rtol=SCORE_TOL[0], atol=SCORE_TOL[1])
    unexplained = int((diff & ~tie).sum())
    check(unexplained == 0, f"wide kernels: {unexplained} stage-2 id "
          f"mismatches not explained by a score tie")
    del ks, ki, ps, pi
    res = {"B": b, "N_pad": n_pad, "d": d, "r": r, "query_tile": tile,
           "launches": launches, "bmax_max_ulps_from_plain": ulps,
           "stage2_id_mismatches_b64": int(diff.sum()),
           "stage2_explained_by_score_tie_b64": int(tie.sum())}
    res["ms"] = median_ms(lambda: bms.int8_blockmax_stage1(*args))
    res["plain_ms"] = median_ms(
        lambda: bms.int8_blockmax_stage1_reference(*args), reps=3, warm=1)
    a8b = a8.to(torch.bfloat16)
    res["library_ms"] = median_ms(
        lambda: torch.matmul(qb, a8b.T).view(b, nblk, bms.BLOCK).amax(-1),
        reps=3, warm=1)
    del a8b
    flops = 2.0 * b * n_pad * d
    nbytes = (b * d * 2 + n_pad * d + n_pad * 4 * 2 + n_pad + b * 4
              + b * nblk * 4)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    res["mirror_bytes"] = bms.stage1_mirror_bytes(b, n_pad, d)
    res["mirror_bytes_at_peak_ms"] = res["mirror_bytes"] / PEAK_BYTES * 1e3
    _, top = stable_topk(bk, nb_sel)
    _, active = bms.stage2_maps(top, nblk, tile)
    stage2 = {"tile_block_pairs_computed": float(active.float().mean()),
              "mirror_bytes": int(bms.stage2_mirror_bytes(active, d))}
    del active
    stage2.update(time_stage2(q, a8, sc, vs, va, bk, top, nb_sel, rr, True))
    res["stage2"] = stage2
    print("wide_kernels " + json.dumps(res), flush=True)
    return res


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
    reduced to HNSWQ_ROWS rows and 1024 centroids (REDUCED): the coarse
    graph is built at train time on the host."""
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
# -- phase 3b: the mesh layer -------------------------------------------------

MESH_SHARDS = 4  # virtual shards of the 4x1 mesh on the one card
MESH_GATED = dict(GATED_PARAMS, topk_mode="blockmax")
MESH_PROBE = dict(PROBE_PARAMS, **GATED_PARAMS)
MESH_FLAT_ITERS = 1  # timed FLAT / FLAT_SHARDED searches (after a warm-up)


def mesh_objective(dev, rows, cents, sample=200_000) -> float:
    """Mean squared L2 distance of `sample` rows to their nearest
    centroid (the k-means objective), on the card."""
    import torch

    x = torch.from_numpy(np.ascontiguousarray(rows[:sample])).to(dev)
    c = cents.to(dev).float()
    c_sq = (c * c).sum(1)
    total = 0.0
    for lo in range(0, x.shape[0], 65_536):
        xc = x[lo:lo + 65_536].float()
        d2 = (xc * xc).sum(1)[:, None] - 2.0 * xc @ c.T + c_sq[None, :]
        total += float(d2.min(1).values.clamp_min(0).sum())
    return total / x.shape[0]


def ids_differing(a, b) -> int:
    return int(sum(x != y for x, y in zip(a.keys, b.keys)))


def phase_mesh(dev, base, queries, truth) -> tuple[dict, dict]:
    """The mesh layer on the card at the main path's rows and width,
    B=1024, through Engine: one IVFPQ engine (the main path's settings)
    served single-device and through a 1x1 mesh (the card) and a 4x1
    mesh of MESH_SHARDS virtual shards on it, in the full scan (rerank
    512, topk_mode "blockmax") and the probe regime (nprobe 64, rerank
    512); FLAT against FLAT_SHARDED over the 4x1 mesh; `mesh_train`
    over the 4x1 mesh against the unsharded build; IVFRABITQ over both
    meshes. Each path's launches are set to 0 just before it and read
    just after."""
    from vearch_tpu_torch.parallel import mesh as mesh_lib

    n = len(base)
    out, paths = {"rows": n, "virtual_shards": MESH_SHARDS}, {}
    mesh_lib.set_virtual_device_count(MESH_SHARDS)
    try:
        # IVFPQ: single device, then the two meshes on the same engine
        eng = main_engine({"mesh_serving": "off"})
        out["ivfpq_build"] = ingest_and_build(eng, base)
        unsharded = eng.indexes["emb"].centroids.clone()
        res = {}
        for name, params, tags in (
                ("single_full", MESH_GATED, ["fused_scan_rerank"]),
                ("single_probe", MESH_PROBE, ["probe_scan", "rerank"]),
                ("mesh1x1_full", dict(MESH_GATED, mesh_serving="on",
                                      mesh_shape="1x1"),
                 ["sharded_fused_scan_rerank"]),
                ("mesh1x1_probe", dict(MESH_PROBE, mesh_serving="on",
                                       mesh_shape="1x1"),
                 ["sharded_probe_scan_rerank"]),
                ("mesh4x1_full", dict(MESH_GATED, mesh_serving="on",
                                      mesh_shape="4x1"),
                 ["sharded_fused_scan_rerank"]),
                ("mesh4x1_probe", dict(MESH_PROBE, mesh_serving="on",
                                       mesh_shape="4x1"),
                 ["sharded_probe_scan_rerank"])):
            paths[name], res[name] = run_path(eng, queries, params, truth)
            check(paths[name]["tags"] == tags,
                  f"mesh path {name} ran {paths[name]['tags']}")
            check(paths[name]["recall_at_10"] >= 0.95,
                  f"mesh path {name} recall@10 "
                  f"{paths[name]['recall_at_10']} < 0.95")
        searches = 4  # run_path: one search, then three timed
        check(paths["single_full"]["launches"]["int8_blockmax_scan"]
              == searches, "single-device full scan launches")
        check(paths["mesh1x1_full"]["launches"]["int8_blockmax_scan"]
              == searches, "the 1x1 mesh's full scan did not launch the "
              "block-max kernel once a search")
        check(paths["mesh4x1_full"]["launches"]["int8_blockmax_scan"]
              == searches * MESH_SHARDS, "the 4x1 mesh's full scan did not "
              "launch the block-max kernel once per shard")
        # mesh and single-device ids are equal in both regimes, and a
        # shard boundary moves no candidate (tests/test_torch_mesh.py
        # holds the same on the CPU)
        for key, a, b in (
                ("full_ids_differing_1x1_vs_single", "mesh1x1_full",
                 "single_full"),
                ("full_ids_differing_4x1_vs_1x1", "mesh4x1_full",
                 "mesh1x1_full"),
                ("probe_ids_differing_1x1_vs_single", "mesh1x1_probe",
                 "single_probe"),
                ("probe_ids_differing_4x1_vs_1x1", "mesh4x1_probe",
                 "mesh1x1_probe")):
            out[key] = ids_differing(res[a], res[b])
            check(out[key] == 0, f"{a} ids differ from {b}'s in "
                  f"{out[key]} rows")
        out["mesh_info"] = eng.mesh_info()
        eng.apply_config({"mesh_serving": "on", "mesh_shape": "4x1"})
        out["mesh_info_4x1"] = eng.mesh_info()
        out["per_device_bytes_4x1"] = \
            eng.indexes["emb"].device_footprint_per_device_bytes()
        out["device_bytes_single"] = \
            eng.indexes["emb"].device_footprint_bytes()
        del res
        eng.close()
        del eng
        release_device_memory()

        # mesh_train over the 4x1 mesh against the unsharded build
        eng = main_engine({"mesh_serving": "off", "mesh_train": True,
                           "mesh_shape": "4x1"})
        out["mesh_train_build"] = ingest_and_build(eng, base)
        index = eng.indexes["emb"]
        check(index.last_train_mesh == "4x1",
              f"mesh_train trained on {index.last_train_mesh}")
        out["objective_mesh_train"] = mesh_objective(dev, base,
                                                     index.centroids)
        out["objective_unsharded"] = mesh_objective(dev, base, unsharded)
        for name, params in (("mesh_train_full", MESH_GATED),
                             ("mesh_train_probe", MESH_PROBE)):
            paths[name], _ = run_path(eng, queries, params, truth)
        for name in ("full", "probe"):
            check(paths[f"mesh_train_{name}"]["recall_at_10"]
                  >= paths[f"single_{name}"]["recall_at_10"] - 0.01,
                  f"mesh_train {name} recall below the unsharded build's")
        check(out["objective_mesh_train"]
              <= 1.02 * out["objective_unsharded"],
              "mesh_train's k-means objective exceeds the unsharded "
              "build's by more than 2%")
        del index, unsharded
        eng.close()
        del eng
        release_device_memory()

        # FLAT against FLAT_SHARDED over the 4x1 mesh
        flat_res = {}
        for name, itype, params in (
                ("flat", "FLAT", {}),
                ("flat_sharded_4x1", "FLAT_SHARDED", {"mesh_shape": "4x1"})):
            eng = family_engine(itype, "L2", dict(
                params, store_dtype="bfloat16"))
            out[f"{name}_build"] = ingest_and_build(eng, base)
            paths[name], flat_res[name] = run_path(
                eng, queries, {}, truth, iters=MESH_FLAT_ITERS)
            eng.close()
            del eng
            release_device_memory()
        check(paths["flat_sharded_4x1"]["tags"] == ["sharded_flat_scan"],
              f"FLAT_SHARDED ran {paths['flat_sharded_4x1']['tags']}")
        # the same exact f32 products in another GEMM shape: scores equal
        # position by position within SCORE_TOL, ids apart from such ties
        sharded, flat = flat_res["flat_sharded_4x1"], flat_res["flat"]
        out["flat_rows_differing"] = ids_differing(sharded, flat)
        out["flat_max_abs_score_diff"] = float(
            np.abs(sharded.scores - flat.scores).max())
        check(np.allclose(sharded.scores, flat.scores, rtol=SCORE_TOL[0],
                          atol=SCORE_TOL[1]),
              "FLAT_SHARDED's scores differ from FLAT's")
        del flat_res, sharded, flat

        # IVFRABITQ over the meshes
        eng = family_engine("IVFRABITQ", "L2", {
            "ncentroids": 2048, "nprobe": 64, "train_iters": 8,
            "training_threshold": 10 ** 9, "store_dtype": "bfloat16"})
        out["ivfrabitq_build"] = ingest_and_build(eng, base)
        for name, params, tags in (
                ("rabitq_single", {"rerank": 256},
                 ["binary_refine_rerank"]),
                ("rabitq_mesh1x1", {"rerank": 256, "mesh_serving": "on",
                                    "mesh_shape": "1x1"},
                 ["sharded_binary_refine_rerank"]),
                ("rabitq_mesh4x1", {"rerank": 256, "mesh_serving": "on",
                                    "mesh_shape": "4x1"},
                 ["sharded_binary_refine_rerank"])):
            paths[name], _ = run_path(eng, queries, params, truth)
            check(paths[name]["tags"] == tags,
                  f"{name} ran {paths[name]['tags']}")
            check(paths[name]["recall_at_10"] >= 0.95,
                  f"{name} recall@10 {paths[name]['recall_at_10']} < 0.95")
        eng.close()
        del eng
    finally:
        mesh_lib.set_virtual_device_count(None)
        release_device_memory()
    return out, paths


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
               # the process's cuBLAS workspaces, which the sampler holds
               # apart from both the baseline and the engine's model
               "blas_workspace_bytes": snap["blas_workspace_bytes"]["cuda:0"],
               "reserved_bytes": measure_reserved_bytes()["cuda:0"],
               "drift_bytes": snap["drift_bytes"], "drift": snap["drift"]}
        row["unmodelled_bytes"] = (row["allocated_bytes"]
                                   - row["baseline_bytes"]
                                   - row["blas_workspace_bytes"]
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
# the gated full scan, selecting by block maxima as the main path's 1M
# rows do under "auto" (REDUCED["cluster"])
CLUSTER_GATED = dict(GATED_PARAMS, topk_mode="blockmax")
CLUSTER_REQUESTS = {
    "full_rerank512": CLUSTER_GATED,
    "full_rerank128": dict(BENCH_PARAMS, topk_mode="blockmax"),
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


def router_search(cl, queries, params, space="s", **kw):
    """One search through the router: (ids [B][k] as row numbers, wall
    ms). B > 1 rides the columnar wire (scores as one f32 buffer)."""
    if len(queries) > 1:
        kw.update(fields=[], columnar=True)
    t0 = time.monotonic()
    out = cl.search("db", space, [{"field": "emb", "feature": queries}],
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


def profiled_tags(cl, queries, params) -> tuple[dict, list]:
    """One B-query search through the router with `profile: true`: the
    profile (router, partitions, engines; its wall ms) and the dispatch
    tags, which must be the same on every partition."""
    t0 = time.monotonic()
    prof = cl.search("db", "s", [{"field": "emb", "feature": queries}],
                     limit=10, index_params=params, cache=False,
                     profile=True)
    prof = dict(prof["profile"], wall_ms=(time.monotonic() - t0) * 1e3)
    tags = {json.dumps(p["dispatches"]["tags"])
            for p in prof["partitions"].values()}
    check(len(tags) == 1, f"partitions dispatched differently: {tags}")
    return prof, json.loads(tags.pop())


def cluster_counts(c, pids=None) -> dict:
    """Each partition's doc count on each of its replicas (node id ->
    count), for the partitions `pids` (default: all) on running
    servers."""
    out = {}
    for ps in c.ps_nodes:
        if ps._stop.is_set():
            continue
        for pid, eng in list(ps.engines.items()):
            if pids is None or pid in pids:
                out.setdefault(str(pid), {})[str(ps.node_id)] = \
                    eng.doc_count
    return out


def cluster_build(c, cl, space="s") -> dict:
    """Every replica builds its own index: the leaders through the
    router's build route (/index/forcemerge, one partition server each,
    at once), then each follower through its partition server's
    /ps/index/build, one at a time. Seconds of each step."""
    from vearch_tpu_torch.cluster import rpc

    sp = cl.get_space("db", space)
    leaders = {p["id"]: p["leader"] for p in sp["partitions"]}
    t0 = time.monotonic()
    rpc.call(c.router_addr, "POST", "/index/forcemerge",
             {"db_name": "db", "space_name": space}, timeout=900.0)
    out = {"leaders_s": time.monotonic() - t0, "followers_s": []}
    for ps in c.ps_nodes:
        if ps._stop.is_set():
            continue
        for pid in sorted(ps.engines):
            if pid in leaders and leaders[pid] != ps.node_id:
                t1 = time.monotonic()
                rpc.call(ps.addr, "POST", "/ps/index/build",
                         {"partition_id": pid}, timeout=900.0)
                out["followers_s"].append(time.monotonic() - t1)
    out["total_s"] = time.monotonic() - t0
    for ps in c.ps_nodes:
        for pid, eng in list(ps.engines.items()):
            if pid in leaders and not ps._stop.is_set():
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


# -- phase 9b: elastic jobs and the operator surface on the card --------------

ELASTIC_ROWS = 10_000  # the elastic space's seed docs (REDUCED)
ELASTIC_WRITES = 1_000  # new docs the bounded writer adds during the split
# ~80 rows a cell in each 5k-row child; nprobe 32 of 64 cells
ELASTIC_PARAMS = {"ncentroids": 64, "nsubvector": 32, "train_iters": 8,
                  "nprobe": 32, "training_threshold": 10 ** 9,
                  "store_dtype": "bfloat16"}
ELASTIC_REQUESTS = {
    "full_rerank512": CLUSTER_GATED,
    "probe_rerank512": dict(GATED_PARAMS, scan_mode="probe", nprobe=32),
}
ELASTIC_KERNELS = {"full_rerank512": "int8_blockmax_scan",
                   "probe_rerank512": "ivf_probe_dots"}


def elastic_space(d=128) -> dict:
    return {"name": "e", "partition_num": 1, "replica_num": 3, "fields": [
        {"name": "emb", "data_type": "vector", "dimension": d,
         "index": {"index_type": "IVFPQ", "metric_type": "L2",
                   "params": ELASTIC_PARAMS}}]}


def wait_registered(c, ps, deadline_s=60.0) -> None:
    from vearch_tpu_torch.cluster import rpc

    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
        if any(s["node_id"] == ps.node_id for s in servers):
            return
        time.sleep(0.1)
    check(False, f"partition server {ps.node_id} never registered")


def elastic_searches(cl, queries, truth, tag) -> tuple[dict, dict]:
    """The gated full scan and the probe regime through the router on
    the elastic space; each must launch its kernel."""
    res, ids = {}, {}
    for name, params in ELASTIC_REQUESTS.items():
        res[name], ids[name] = cluster_path(cl, queries, params, truth,
                                            ELASTIC_KERNELS[name], space="e")
        print(f"elastic_search {tag} {name} " + json.dumps(res[name]),
              flush=True)
    return res, ids


def elastic_counts(c, cl, want, space="e", deadline_s=120.0) -> dict:
    """Poll (with a deadline) until every replica of every partition of
    `space` counts the same docs, each partition has 3 replicas on
    running servers, and the partitions sum to `want`."""
    deadline = time.monotonic() + deadline_s
    while True:
        pids = {p["id"] for p in cl.get_space("db", space)["partitions"]}
        counts = cluster_counts(c, pids)
        ok = (set(counts) == {str(p) for p in pids}
              and all(len(r) == 3 and len(set(r.values())) == 1
                      for r in counts.values())
              and sum(next(iter(r.values())) for r in counts.values())
              == want)
        if ok or time.monotonic() > deadline:
            check(ok, f"{space} doc counts {counts}, want {want}")
            return counts
        time.sleep(0.2)


def rows_differing(a, b) -> int:
    return int(sum(x != y for x, y in zip(a, b)))


def elastic_data(d=128, b=1024, seed=7, seeds=ELASTIC_ROWS):
    """bench.py's recipe at the elastic space's size and at its density
    (200 rows a cluster, as 1M rows in 5000 clusters): `seeds` seed rows
    and ELASTIC_WRITES more for the writer, and B queries perturbed from
    seed rows (as build_data's are from its rows)."""
    n = seeds + ELASTIC_WRITES
    rows = build_data(n=n, d=d, seed=seed, nc=n // 200)[0]
    rng = np.random.default_rng(seed + 1)
    queries = rows[rng.choice(seeds, b, replace=False)] + 0.1 * \
        rng.standard_normal((b, d)).astype(np.float32)
    return rows, queries.astype(np.float32)


# the doctor's violations this run may show, each with its cause; any
# other violation fails the run
DOCTOR_EXPECTED = {
    "post_warmup_compiles": "the flight recorder's warm-up ends with the "
                            "kernel builds at start (in phase_processes, "
                            "with each server's start), so every later "
                            "first launch shape (split children, moved "
                            "replicas, a server's first searches) is a "
                            "compile event after it",
    "hbm_drift": "each partition server's sampler holds the process's "
                 "allocated bytes against its own engines' models and "
                 "cuBLAS workspaces: in phase_cluster every server shares "
                 "one process and one card, so each server's sampler "
                 "sees the others' engines (reference semantics); "
                 "phase_processes, one server a process, allows it no "
                 "more",
    "cardinality_ceiling": "a partition server's /metrics page carries "
                           "series per hosted partition, as the "
                           "reference's does; after the split and the "
                           "moves a server hosts 4-5 partitions (3 in "
                           "phase_processes), past the ceiling the "
                           "2-partition CI soak sets",
}


def phase_elastic(dev, c, cluster_ref, d=128) -> tuple[dict, dict]:
    """The elastic jobs on phase_cluster's cluster `c` after its failover
    (one server stopped; each partition of the space "s" left with 2
    replicas): a fresh partition server joins and the master re-places
    the lost "s" replicas on it (caught up by log replay); a space of
    ELASTIC_ROWS docs (`elastic_data`: 1 partition x 3 replicas, IVFPQ at
    full width) is built and searched; its partition splits while a
    bounded writer adds ELASTIC_WRITES new docs; the children are built
    and searched (both kernels on the children); a child's replica
    migrates to a second fresh server and the first is drained, which
    moves the re-placed "s" replicas too. Doc counts on every replica
    must equal the seeds plus the acked writes (and the "s" rows); recall
    @10 >= 0.95 before and after each job, on "s" too. Then the doctor
    runs against the cluster. `cluster_ref` holds phase_cluster's
    queries, truth, rows and ids before the failover."""
    import threading

    from vearch_tpu_torch.cluster import rpc
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.obs import doctor
    from vearch_tpu_torch.sdk.client import VearchClient

    # the elastic verbs go to the master, the searches to the router
    cl = VearchClient(c.router_addr, master_addr=c.master_addr)
    out, paths, times = {"rows": ELASTIC_ROWS,
                         "reduced": REDUCED["elastic"]}, {}, {}
    base, queries = elastic_data(d)
    t_phase = time.monotonic()
    # the port's lint CLI over this checkout, in its own process (pure
    # host work) while the jobs below run; read before the doctor
    import vearch_tpu_torch

    lint_pool = ThreadPoolExecutor(1)
    lint_run = lint_pool.submit(run_lint, os.path.dirname(
        os.path.abspath(vearch_tpu_torch.__file__)))
    lint_pool.shutdown(wait=False)

    def step(name):
        print(f"elastic: {name} at {time.monotonic() - t_phase:.1f}s",
              flush=True)

    t0 = time.monotonic()
    fresh_a = c.add_ps()
    wait_registered(c, fresh_a)
    s_pids = sorted(p["id"] for p in cl.get_space("db", "s")["partitions"])
    cl.create_space("db", elastic_space(base.shape[1]))
    for lo in range(0, ELASTIC_ROWS, CLUSTER_BATCH):
        cl.upsert("db", "e", [{"_id": f"d{j}", "emb": base[j]} for j in
                              range(lo, min(lo + CLUSTER_BATCH,
                                            ELASTIC_ROWS))])
    times["ingest"] = time.monotonic() - t0
    step("ingested")
    out["seed_counts"] = elastic_counts(c, cl, ELASTIC_ROWS)
    out["build"] = cluster_build(c, cl, space="e")
    step("built")
    # the master re-placed the replicas the failover dropped on the fresh
    # server (auto-recover), which caught up by log replay meanwhile
    n_s = cluster_ref["rows"]
    out["s_rereplicated_counts"] = elastic_counts(c, cl, n_s, space="s",
                                                  deadline_s=600.0)
    times["s_rereplicated"] = time.monotonic() - t_phase
    check(all(str(fresh_a.node_id) in r
              for r in out["s_rereplicated_counts"].values()),
          "the fresh server holds no re-placed replica of every "
          f"partition of s: {out['s_rereplicated_counts']}")
    step("s re-replicated")
    truth = exact_topk(dev, queries, base[:ELASTIC_ROWS], MetricType.L2)
    before, ids_before = elastic_searches(cl, queries, truth, "before")
    for name, res in before.items():
        paths[f"before_{name}"] = res
        check(res["recall_at_10"] >= 0.95,
              f"elastic {name} recall@10 {res['recall_at_10']} < 0.95")

    # the split, under a bounded writer of new docs
    parent = cl.get_space("db", "e")["partitions"][0]["id"]
    acked, errors = [], []

    def writer():
        from vearch_tpu_torch.sdk.client import VearchClient

        wc = VearchClient(c.router_addr)
        try:
            for lo in range(ELASTIC_ROWS, ELASTIC_ROWS + ELASTIC_WRITES,
                            200):
                wc.upsert("db", "e", [{"_id": f"d{j}", "emb": base[j]}
                                      for j in range(lo, lo + 200)])
                acked.append(lo + 200)
        except Exception as e:  # reported and failed below
            errors.append(repr(e))

    t = threading.Thread(target=writer, name="elastic-writer", daemon=True)
    t0 = time.monotonic()
    t.start()
    job = cl.split_partition("db", "e", parent, timeout_s=300.0)
    done = cl.wait_elastic_job(job["job_id"], timeout_s=300.0)
    split_s = time.monotonic() - t0
    t.join()
    step("split")
    check(not errors, f"elastic writer failed: {errors}")
    check(done["status"] == "done", f"split job {done}")
    rows = acked[-1] if acked else ELASTIC_ROWS
    children = sorted(p["id"] for p in cl.get_space(
        "db", "e")["partitions"])
    check(len(children) == 2 and parent not in children,
          f"split children {children}")
    detail = done.get("detail") or {}
    out["split"] = {"job_s": split_s, "parent": parent,
                    "children": children, "acked_writes": rows - ELASTIC_ROWS,
                    "detail": detail,
                    "copy_docs_per_s": ELASTIC_ROWS / split_s}
    # what a split of one of phase_cluster's partitions would take at
    # this copy rate (REDUCED["elastic"])
    out["split"]["projected_s_for_an_s_partition"] = (
        n_s / len(s_pids)) / out["split"]["copy_docs_per_s"]
    out["split_counts"] = elastic_counts(c, cl, rows)
    for ps in c.ps_nodes:
        if not ps._stop.is_set():
            for pid, eng in list(ps.engines.items()):
                if pid in children:
                    check(eng.device.type == "cuda"
                          and eng.vector_stores["emb"].device.type == "cuda",
                          f"child {pid} on node {ps.node_id} is not on "
                          "the card")
    out["child_build"] = cluster_build(c, cl, space="e")
    step("children built")
    truth = exact_topk(dev, queries, base[:rows], MetricType.L2)
    after, ids_after = elastic_searches(cl, queries, truth, "after_split")
    for name, res in after.items():
        paths[f"after_split_{name}"] = res
        check(res["recall_at_10"] >= 0.95,
              f"elastic {name} after the split: recall@10 "
              f"{res['recall_at_10']} < 0.95")
        res["rows_differing_before"] = rows_differing(ids_after[name],
                                                      ids_before[name])
    print("elastic_split " + json.dumps(out["split"]), flush=True)

    # migrate a child's replica from the first fresh server to a second,
    # then drain the first: its other child and the re-placed "s"
    # replicas move too
    t0 = time.monotonic()
    fresh_b = c.add_ps()
    wait_registered(c, fresh_b)
    moved = next(p for p in cl.get_space("db", "e")["partitions"]
                 if fresh_a.node_id in p["replicas"])
    job = cl.migrate_partition(moved["id"], to_node=fresh_b.node_id,
                               from_node=fresh_a.node_id, timeout_s=300.0)
    mig = cl.wait_elastic_job(job["job_id"], timeout_s=300.0)
    check(mig["status"] == "done", f"migrate job {mig}")
    times["migrate"] = time.monotonic() - t0
    step("migrated")
    t0 = time.monotonic()
    drain = cl.drain(fresh_a.node_id, apply=True)
    if drain.get("job_id"):
        drain = cl.wait_elastic_job(drain["job_id"], timeout_s=300.0)
        check(drain["status"] == "done", f"drain job {drain}")
    times["drain"] = time.monotonic() - t0
    step("drained")
    out["drain"] = {"moves": [
        {k: m.get(k) for k in ("partition_id", "from_node", "to_node",
                               "status")} for m in drain.get("steps", [])]}
    check({m["partition_id"] for m in out["drain"]["moves"]} >= set(s_pids),
          f"the drain did not move the s replicas: {out['drain']}")
    servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
    left = next(s for s in servers if s["node_id"] == fresh_a.node_id)
    check(left["partition_ids"] == [], f"drained server holds {left}")
    out["migrated_partition"] = moved["id"]
    out["moved_counts"] = elastic_counts(c, cl, rows)
    out["s_moved_counts"] = elastic_counts(c, cl, n_s, space="s")
    check(all(str(fresh_b.node_id) in r
              for r in out["s_moved_counts"].values()),
          f"s replicas not on the drain's target: {out['s_moved_counts']}")
    # a moved replica arrives unindexed, as the reference's does (its
    # snapshot carries the rows, not the index): build it before the
    # searches, or a hedge or a promoted leader answers by brute force
    out["moved_build"] = cluster_build(c, cl, space="e")
    out["s_moved_build"] = cluster_build(c, cl, space="s")
    step("moved replicas built")
    for ps in c.ps_nodes:
        if not ps._stop.is_set():
            for pid, eng in list(ps.engines.items()):
                if pid in children or pid in s_pids:
                    check(eng.device.type == "cuda",
                          f"moved replica {pid} on node {ps.node_id} is "
                          "not on the card")
    moved_res, ids_moved = elastic_searches(cl, queries, truth, "after_moves")
    for name, res in moved_res.items():
        paths[f"after_moves_{name}"] = res
        check(res["recall_at_10"] >= 0.95,
              f"elastic {name} after the moves: recall@10 "
              f"{res['recall_at_10']} < 0.95")
        res["rows_differing_after_split"] = rows_differing(
            ids_moved[name], ids_after[name])
    # the cluster's own space after its replicas moved: recall held
    res, ids = cluster_path(cl, cluster_ref["queries"], CLUSTER_GATED,
                            cluster_ref["truth"], "int8_blockmax_scan")
    check(res["recall_at_10"] >= 0.95,
          f"s recall@10 after the drain {res['recall_at_10']} < 0.95")
    res["rows_differing_before_failover"] = rows_differing(
        ids, cluster_ref["before"])
    paths["s_after_drain"] = res
    print("elastic_search s_after_drain " + json.dumps(res), flush=True)
    out["searches"] = {"before": before, "after_split": after,
                       "after_moves": moved_res, "s_after_drain": res}

    # the lint's summary line, then the operator surface: the doctor over
    # this cluster, whose lint_clean runs the same suite; no gRPC here
    lint = lint_run.result()
    print(lint.pop("output").rstrip(), flush=True)
    out["lint"] = dict(lint, card=nvidia_smi())
    print(f"lint: {lint['seconds']:.3f}s on {out['lint']['card']}",
          flush=True)
    check(lint["exit_code"] == 0, f"vearch-lint exit {lint['exit_code']}")
    # the doctor reads each server's last index-health sample, taken
    # every 10 s: sample it now, after the moved replicas' builds, or a
    # replica built within the period reads as unindexed
    for ps in c.ps_nodes:
        if not ps._stop.is_set():
            ps._quality.collect_health()
    t0 = time.monotonic()
    report, code = doctor.run(c.master_addr)
    out["doctor"] = {"exit_code": code,
                     "checks": {ch["name"]: ch["ok"]
                                for ch in report["checks"]},
                     "violations": [v["name"] for v in report["violations"]],
                     "seconds": time.monotonic() - t0}
    print("doctor " + json.dumps(out["doctor"]), flush=True)
    print(doctor.format_report(report), flush=True)
    out["doctor"]["causes"] = {v: DOCTOR_EXPECTED.get(v, "unexplained")
                               for v in out["doctor"]["violations"]}
    check(code in (0, 1) and set(out["doctor"]["violations"])
          <= set(DOCTOR_EXPECTED),
          f"doctor exit {code}: unexplained violations "
          f"{sorted(set(out['doctor']['violations']) - set(DOCTOR_EXPECTED))}")
    lint_check = next(ch for ch in report["checks"]
                      if ch["name"] == "lint_clean")
    check(lint_check["ok"] is True and not lint_check.get("skipped"),
          f"doctor lint_clean: {lint_check}")
    out["seconds"] = times
    return out, paths


# -- phase 9c: the cluster's roles as processes -------------------------------

PROCESS_FAILOVER_WRITES = 5_000  # new docs written across the kill -9
PROCESS_S3_ROWS = 5_000  # docs of the S3 round trip's space (REDUCED)
PROCESS_DEADLINE_S = 120.0  # each wait of phase_processes
# a partition server samples its card every 5 s (DeviceSampler's
# default) and its engines' index health every 10 s (QualityMonitor's);
# the doctor reads the last samples, so it runs one period of each after
# the last request and the last build, not on a search's workspace or
# the health of an engine from before its build or restore
PROCESS_QUIET_S = 11.0
PROCESS_METRIC = re.compile(
    r'^vearch_ps_device_hbm_live_bytes\{device="([^"]+)"\} (\S+)$', re.M)


def smoke_torch():
    """cloud/smoke_torch.py (the port's cluster smoke) as a module: its
    `Roles`, `start_topology`, `meta_leader` and `MockS3` drive
    phase_processes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "smoke_torch", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "cloud", "smoke_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compute_apps() -> list:
    """The card's compute contexts as nvidia-smi lists them: [pid,
    process name, MiB] rows."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return [line.split(", ") for line in out.stdout.strip().splitlines()
            if line.strip()]


def ps_device_bytes(addr: str) -> dict:
    """`vearch_ps_device_hbm_live_bytes` per device label, read from a
    partition server's /metrics page."""
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=30) as r:
        text = r.read().decode()
    return {m.group(1): float(m.group(2))
            for m in PROCESS_METRIC.finditer(text)}


def process_counts(ps_addrs, pids) -> dict:
    """Each partition's doc count on each replica (node id -> count),
    read from the /ps/stats of every partition server in `ps_addrs`
    (node id -> address), for the partitions `pids`."""
    from vearch_tpu_torch.cluster import rpc

    out = {}
    for node, addr in ps_addrs.items():
        try:
            stats = rpc.call(addr, "GET", "/ps/stats", timeout=30.0)
        except rpc.RpcError:
            continue
        for pid, part in stats["partitions"].items():
            if int(pid) in pids:
                out.setdefault(pid, {})[str(node)] = part["doc_count"]
    return out


def process_raft(ps_addrs, pids) -> dict:
    """Each replica's raft state (role, term, commit, applied, log
    indexes) of the partitions `pids`: what a failed wait reports."""
    from vearch_tpu_torch.cluster import rpc

    out = {}
    for node, addr in ps_addrs.items():
        try:
            stats = rpc.call(addr, "GET", "/ps/stats", timeout=30.0)
        except rpc.RpcError as e:
            out[str(node)] = repr(e)
            continue
        for pid, part in stats["partitions"].items():
            if int(pid) in pids:
                out[f"{pid}@{node}"] = dict(part["raft"] or {},
                                            status=part["status"])
    return out


def wait_process_counts(cl, ps_addrs, want, space="s",
                        deadline_s=PROCESS_DEADLINE_S) -> tuple[dict, float]:
    """Poll, under a deadline, until every partition of `space` counts the
    same docs on 3 replicas and the partitions sum to `want`: the counts
    and the seconds it took."""
    t0 = time.monotonic()
    while True:
        pids = {p["id"] for p in cl.get_space("db", space)["partitions"]}
        counts = process_counts(ps_addrs, pids)
        ok = (set(counts) == {str(p) for p in pids}
              and all(len(r) == 3 and len(set(r.values())) == 1
                      for r in counts.values())
              and sum(next(iter(r.values())) for r in counts.values())
              == want)
        if ok or time.monotonic() - t0 > deadline_s:
            check(ok, f"{space} doc counts {counts}, want {want} on 3 "
                      f"replicas within {deadline_s} s; raft state "
                      f"{process_raft(ps_addrs, pids)}")
            return counts, time.monotonic() - t0
        time.sleep(0.2)


def process_build(cl, ps_addrs, space="s") -> dict:
    """Every replica builds its own index, at once: the leaders through
    the router's /index/forcemerge, each follower through its partition
    server's /ps/index/build (each server is its own process). Seconds,
    and every replica's engine status after (3: indexed)."""
    from vearch_tpu_torch.cluster import rpc

    parts = cl.get_space("db", space)["partitions"]
    t0 = time.monotonic()
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(rpc.call, cl.addr, "POST", "/index/forcemerge",
                            {"db_name": "db", "space_name": space},
                            timeout=900.0)]
        futs += [pool.submit(rpc.call, ps_addrs[r], "POST", "/ps/index/build",
                             {"partition_id": p["id"]}, timeout=900.0)
                 for p in parts for r in p["replicas"]
                 if r != p["leader"] and r in ps_addrs]
        for fut in futs:
            fut.result()
    out = {"total_s": time.monotonic() - t0, "status": {}}
    pids = {p["id"] for p in parts}
    for node, addr in ps_addrs.items():
        stats = rpc.call(addr, "GET", "/ps/stats", timeout=30.0)
        for pid, part in stats["partitions"].items():
            if int(pid) in pids:
                out["status"].setdefault(pid, {})[str(node)] = part["status"]
    check(all(s == 3 for r in out["status"].values() for s in r.values()),
          f"{space} replicas not indexed after the build: {out['status']}")
    return out


def process_path(cls, queries, params, truth, space="s") -> tuple:
    """A warm-up, then 3 searches through the routers in turn (router1,
    router2, router1; the median's ms): recall@10 and the last ids."""
    router_search(cls[0], queries, params, space=space)
    times = []
    for i in range(3):
        ids, ms = router_search(cls[i % 2], queries, params, space=space)
        times.append(ms)
    return {"params": params, "B": len(queries),
            "search_ms": float(np.median(times)), "all_ms": times,
            "recall_at_10": cluster_recall(ids, truth)}, ids


# -- the census of one partition server's device bytes ------------------------

CENSUS_ROWS = PROCESS_ROWS  # rows of the census's server
CENSUS_CLIENTS = 8  # client threads searching the census's server at once
CENSUS_WRITES = 5_000  # docs its writer re-upserts beside the searches


def census_frame(f: dict) -> str:
    """One frame of an allocation stack: the path from the package down
    (the file name outside it), line and function."""
    fn = f["filename"]
    i = fn.find("vearch_tpu_torch")
    return (f"{fn[i:] if i >= 0 else os.path.basename(fn)}:{f['line']} "
            f"{f['name']}")


def census_attribute(snapshot) -> list:
    """Every live block of an allocator snapshot taken with memory
    history, grouped by the stack that allocated it: the innermost frame
    in the port and the thread's entry (its outermost frame outside
    threading.py). [{stack, bytes, blocks, sizes}], largest first."""
    import collections

    groups: dict = {}
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = [f for f in blk.get("frames") or []
                      if f.get("filename")]
            # innermost frame first, as the allocator records them
            port = [f for f in frames if "vearch_tpu_torch" in f["filename"]
                    or f["filename"].endswith("chip_smoke.py")]
            outer = [f for f in frames
                     if not f["filename"].endswith("threading.py")]

            key = " <- ".join(
                [census_frame(port[0]) if port else "(no port frame)",
                 "thread " + (census_frame(outer[-1]) if outer
                              else "(no stack)")])
            g = groups.setdefault(key, {"stack": key, "bytes": 0, "blocks": 0,
                                        "sizes": collections.Counter(),
                                        "frames": [census_frame(f)
                                                   for f in frames[:8]]})
            g["bytes"] += int(blk["size"])
            g["blocks"] += 1
            g["sizes"][int(blk["size"])] += 1
    out = sorted(groups.values(), key=lambda g: -g["bytes"])
    for g in out:
        g["sizes"] = dict(g["sizes"].most_common(4))
    return out


def census_live_blocks(snapshot) -> dict:
    """Every live block of an allocator snapshot, keyed by (address,
    size, its three innermost frames), so that a block freed and another
    allocated at the same address are two keys: {key: [size,
    requested_size, stack]}. A block may be larger than its request: the
    allocator hands out a cached block whole when the rest would be too
    small to split off."""
    live = {}
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = [census_frame(f) for f in blk.get("frames") or []
                      if f.get("filename")]
            size = int(blk["size"])
            live[(int(blk["address"]), size, tuple(frames[:3]))] = [
                size, int(blk.get("requested_size", size)),
                " <- ".join(frames[:3])]
    return live


def census_cleared(before_snap, after_snap, ws_size: int) -> dict:
    """What torch._C._cuda_clearCublasWorkspaces() freed, read block by
    block from allocator snapshots taken just before and just after it:
    the freed blocks requested at one workspace's size are the
    workspaces (`workspace_bytes`, their requested bytes; the blocks'
    own sizes, which the live-byte count sees, may be larger by what the
    allocator did not split off: `workspace_rounding_bytes`). A block
    the server's own threads free or allocate in the same moment is
    named apart, with its stack, and not counted as a workspace."""
    before = census_live_blocks(before_snap)
    after = census_live_blocks(after_snap)
    freed = [before[k] for k in before.keys() - after.keys()]
    allocated = [after[k] for k in after.keys() - before.keys()]
    ws = [b for b in freed if b[1] == ws_size]
    other = [b for b in freed if b[1] != ws_size]
    return {"workspace_bytes": sum(b[1] for b in ws),
            "workspace_blocks": len(ws),
            "workspace_rounding_bytes": sum(b[0] - b[1] for b in ws),
            "other_freed_bytes": sum(b[0] for b in other),
            "other_freed": other[:8],
            "allocated_meanwhile_bytes": sum(b[0] for b in allocated),
            "allocated_meanwhile": allocated[:8]}


def census_main() -> int:
    """One partition server alone on the card, in this process, with the
    allocator's memory history recorded from before it starts (run as
    `python3 -c "import chip_smoke; chip_smoke.census_main()"`). An
    in-process master and router (neither touches the card) and
    phase_processes' traffic: CENSUS_ROWS rows of phase_cluster's space
    (both partitions on this server) ingested through the router from
    two threads, the build, then CENSUS_CLIENTS client threads searching
    (each of CLUSTER_REQUESTS, a filtered one, B=1) while a writer
    re-upserts CENSUS_WRITES docs. Then, one sampler period after the
    last request: the server's sampler (its drift with the cuBLAS
    workspaces counted, and without, as before the repair), every live
    block attributed to the stack that allocated it, and what
    torch._C._cuda_clearCublasWorkspaces(), which frees the workspaces and
    nothing else, freed (census_cleared). One `census {json}` line."""
    import threading

    import torch

    from vearch_tpu_torch.cluster import rpc
    from vearch_tpu_torch.cluster.master import MasterServer
    from vearch_tpu_torch.cluster.ps import PSServer
    from vearch_tpu_torch.cluster.router import RouterServer
    from vearch_tpu_torch.obs import sampler
    from vearch_tpu_torch.sdk.client import VearchClient

    if not torch.cuda.is_available():
        print("census: no CUDA device visible", file=sys.stderr)
        return 2
    torch.cuda.memory._record_memory_history(max_entries=200_000,
                                             stacks="python")
    n, d = CENSUS_ROWS, 128
    rows, queries = build_data(n=n, d=d)
    cats = engine_docs(rows, seed=12)[0]
    data_dir = tempfile.mkdtemp(prefix="vearch_chip_census_")
    master = MasterServer()
    master.start()
    ps = PSServer(data_dir=os.path.join(data_dir, "ps"),
                  master_addr=master.addr)
    ps.start()
    router = RouterServer(master_addr=master.addr)
    router.start()
    out = {"rows": n, "clients": CENSUS_CLIENTS, "torch": torch.__version__,
           "cuda": torch.version.cuda, "card": nvidia_smi()}
    t_start = time.monotonic()
    try:
        cl = VearchClient(router.addr)
        cl.create_database("db")
        cl.create_space("db", dict(cluster_space(d), replica_num=1))

        def send(lo, hi):
            c = VearchClient(router.addr)
            for i in range(lo, hi, CLUSTER_BATCH):
                c.upsert("db", "s", [{"_id": f"d{j}", "emb": rows[j],
                                      "cat": int(cats[j])}
                                     for j in range(i, min(i + CLUSTER_BATCH,
                                                           hi))])

        with ThreadPoolExecutor(2) as pool:
            for fut in [pool.submit(send, lo, lo + n // 2)
                        for lo in (0, n // 2)]:
                fut.result()
        rpc.call(router.addr, "POST", "/index/forcemerge",
                 {"db_name": "db", "space_name": "s"}, timeout=900.0)

        def client(i):
            c = VearchClient(router.addr)
            for params in CLUSTER_REQUESTS.values():
                router_search(c, queries, params)
            router_search(c, queries, CLUSTER_GATED,
                          filters=CLUSTER_FILTER)
            for j in range(4):
                router_search(c, queries[i * 4 + j:i * 4 + j + 1],
                              CLUSTER_GATED)

        def writer():
            c = VearchClient(router.addr)
            for lo in range(0, min(CENSUS_WRITES, n // 500 * 500), 500):
                c.upsert("db", "s", [{"_id": f"d{j}", "emb": rows[j],
                                      "cat": int(cats[j])}
                                     for j in range(lo, lo + 500)])

        with ThreadPoolExecutor(CENSUS_CLIENTS + 1) as pool:
            futs = [pool.submit(client, i) for i in range(CENSUS_CLIENTS)]
            futs.append(pool.submit(writer))
            for fut in futs:
                fut.result()
        time.sleep(ps.device_sampler.interval_s)
        st = ps.device_sampler.sample_now()
        lbl = next(iter(st["devices"]))
        measured = st["devices"][lbl]
        base = st["baseline_per_device_bytes"].get(lbl, 0)
        model = st["model_per_device_bytes"]
        modelled_ws = st["blas_workspace_bytes"][lbl]
        out["sampler"] = {
            "measured": measured, "engines_model": model,
            "baseline": base, "blas_workspace_bytes": modelled_ws,
            "drift_bytes": st["drift_bytes"], "drift": st["drift"],
            "slack": ps.device_sampler.drift_slack_bytes
            + ps.device_sampler.drift_tolerance * model,
            # the same sample held as before the repair: the engines'
            # models alone
            "drift_bytes_engines_only": measured - model - base}
        out["threads"] = len(threading.enumerate())
        snap_before = torch.cuda.memory._snapshot()
        out["by_stack"] = census_attribute(snap_before)
        before = sampler.measure_live_bytes()[lbl]
        torch._C._cuda_clearCublasWorkspaces()
        after = sampler.measure_live_bytes()[lbl]
        ws_size = perf_model.cublas_workspace_size(torch.device(lbl))
        out["cleared"] = dict(
            census_cleared(snap_before, torch.cuda.memory._snapshot(),
                           ws_size),
            live_before=before, live_after=after, workspace_size=ws_size,
            after_minus_engines_model=after - model - base)
        out["seconds"] = time.monotonic() - t_start
    finally:
        router.stop()
        ps.stop()
        master.stop()
        torch.cuda.memory._record_memory_history(enabled=None)
        shutil.rmtree(data_dir, ignore_errors=True)
    print("census " + json.dumps(out), flush=True)
    return 0


def process_census() -> dict:
    """census_main in a process of its own (a fresh allocator and no
    other server on it): its line, with the repair's checks. The
    sampler's drift, with the cuBLAS workspaces counted, must be false,
    and the blocks requested as workspaces that
    torch._C._cuda_clearCublasWorkspaces() frees must be the workspaces
    the sampler counted, to the byte."""
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.census_main())"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("census ")]
    check(run.returncode == 0 and len(lines) == 1,
          f"census exit {run.returncode}: {run.stderr[-3000:]}")
    census = json.loads(lines[0][len("census "):])
    census["wall_s"] = time.monotonic() - t0
    samp, cleared = census["sampler"], census["cleared"]
    check(not samp["drift"], f"census: the server drifts {samp}")
    check(cleared["workspace_bytes"] == samp["blas_workspace_bytes"],
          f"census: clearing freed {cleared['workspace_bytes']} bytes "
          f"requested as workspaces, the sampler counted "
          f"{samp['blas_workspace_bytes']} of cuBLAS workspaces ({cleared})")
    return census


GRPC_DOCS = 8  # new docs the gRPC step upserts, finds, queries and deletes


def process_grpc(gaddr, cl, ps_addrs, queries, new_rows, want_tags) -> dict:
    """smoke_torch's step 3b through one router's gRPC port (`gaddr`),
    beside the same requests over its REST port (`cl`): the gated full
    scan (B queries), ids equal; its dispatch tags, read from the trace a
    first gRPC search leaves on the partition servers (`ps_addrs`), must
    be `want_tags`; then three B-query batches each way (the queries
    rolled by 1, 2, 3 rows: a request neither way has sent, so no result
    cache serves it, and no trace), ids equal, the median ms of each;
    then GRPC_DOCS new docs (`new_rows`) upserted, each found as its own
    top hit (over REST too), queried by id and deleted over gRPC."""
    import urllib.request

    import grpc

    from vearch_tpu_torch.cluster.grpc_server import load_pb2

    pb2 = load_pb2()
    ch = grpc.insecure_channel(gaddr, options=[
        ("grpc.max_send_message_length", 64 << 20),
        ("grpc.max_receive_message_length", 64 << 20)])

    def stub(name, req, resp):
        return ch.unary_unary(f"/vearch_tpu.Router/{name}",
                              request_serializer=req.SerializeToString,
                              response_deserializer=resp.FromString)

    search = stub("Search", pb2.SearchRequest, pb2.SearchResponse)
    upsert = stub("Upsert", pb2.UpsertRequest, pb2.UpsertResponse)
    query = stub("Query", pb2.QueryRequest, pb2.QueryResponse)
    delete = stub("Delete", pb2.DeleteRequest, pb2.DeleteResponse)

    def grpc_search(q, trace=False):
        t0 = time.monotonic()
        resp = search(pb2.SearchRequest(
            db_name="db", space_name="s", limit=10, trace=trace,
            fields=["cat"], index_params_json=json.dumps(CLUSTER_GATED),
            vectors=[pb2.VectorQuery(field="emb", feature=np.ascontiguousarray(
                q, np.float32).ravel().tolist())]), timeout=600)
        ms = (time.monotonic() - t0) * 1e3
        return [[it.id for it in r.items] for r in resp.results], ms, \
            resp.trace_id

    def as_rows(ids):
        return [[int(i[1:]) for i in row] for row in ids]

    out = {"addr": gaddr, "B": len(queries)}
    try:
        ids, _, trace_id = grpc_search(queries, trace=True)
        check(as_rows(ids) == router_search(cl, queries, CLUSTER_GATED)[0],
              f"gRPC ids through {gaddr} differ from REST's")
        tags = set()
        for addr in ps_addrs.values():
            with urllib.request.urlopen(
                    f"http://{addr}/debug/traces?trace_id={trace_id}",
                    timeout=30) as r:
                body = json.loads(r.read())
            data = body.get("data", body)
            spans = data.get("spans", []) if isinstance(data, dict) else data
            tags |= {json.dumps(sp["tags"]["dispatches"]) for sp in spans
                     if sp["name"] == "ps.search"
                     and "dispatches" in sp.get("tags", {})}
        out["dispatch_tags"] = sorted(json.loads(t) for t in tags)
        check(out["dispatch_tags"] == [want_tags],
              f"gRPC searches dispatched {out['dispatch_tags']}, over REST "
              f"{want_tags}")
        rest_ms, grpc_ms = [], []
        for i in (1, 2, 3):
            q = np.roll(queries, i, axis=0)
            rest_ids, ms = router_search(cl, q, CLUSTER_GATED)
            rest_ms.append(ms)
            ids, ms, _ = grpc_search(q)
            grpc_ms.append(ms)
            check(as_rows(ids) == rest_ids,
                  f"gRPC ids through {gaddr} differ from REST's")
        out.update(rest_ms=float(np.median(rest_ms)), rest_all_ms=rest_ms,
                   grpc_ms=float(np.median(grpc_ms)), grpc_all_ms=grpc_ms)
        new_ids = [f"g{i}" for i in range(len(new_rows))]
        resp = upsert(pb2.UpsertRequest(db_name="db", space_name="s",
                                        documents=[pb2.Document(
                                            id=i, fields_json=json.dumps(
                                                {"emb": v.tolist(),
                                                 "cat": 0}))
                                            for i, v in zip(new_ids,
                                                            new_rows)]),
                      timeout=120)
        check(resp.total == len(new_ids), f"gRPC upsert {resp}")
        deadline = time.monotonic() + PROCESS_DEADLINE_S
        while True:
            ids = grpc_search(new_rows, trace=True)[0]
            if [row[0] for row in ids] == new_ids:
                break
            check(time.monotonic() < deadline,
                  f"gRPC upserted docs not found: {ids}")
            time.sleep(0.2)
        rest = cl.search("db", "s", [{"field": "emb", "feature": new_rows}],
                         limit=10, index_params=CLUSTER_GATED, cache=False)
        check([[h["_id"] for h in row] for row in rest] == ids,
              "gRPC ids of the new docs differ from REST's")
        got = query(pb2.QueryRequest(db_name="db", space_name="s",
                                     document_ids=new_ids), timeout=120)
        check(sorted(d.id for d in got.documents) == new_ids,
              f"gRPC query {got}")
        gone = delete(pb2.DeleteRequest(db_name="db", space_name="s",
                                        document_ids=new_ids), timeout=120)
        check(gone.total == len(new_ids), f"gRPC delete {gone}")
        left = query(pb2.QueryRequest(db_name="db", space_name="s",
                                      document_ids=new_ids), timeout=120)
        check(not left.documents, f"deleted docs still served: {left}")
        out["new_docs"] = {"upserted": len(new_ids), "found": len(new_ids),
                           "deleted": gone.total}
    finally:
        ch.close()
    return out


INTEGRATION_TEXTS = 300  # texts each framework store adds
INTEGRATION_DIM = 64  # the toy embedding's width


def toy_embedding(texts, seed=14) -> list:
    """A seeded toy embedding: each text's vector drawn from a generator
    seeded by `seed` and the text's crc32."""
    import zlib

    return [np.random.default_rng([seed, zlib.crc32(t.encode())])
            .standard_normal(INTEGRATION_DIM).astype(np.float32).tolist()
            for t in texts]


def process_integrations(addr) -> dict:
    """The framework integrations over one router (`addr`), each store
    from vearch_tpu_torch.sdk.integrations on the port's SDK: a LangChain
    store and a LlamaIndex store each add INTEGRATION_TEXTS texts with
    toy_embedding (FLAT spaces of their own, served by the partition
    servers on the card); every probed text's top hit is itself; a second
    store opened on the existing space reads the same; then deletes (by
    id, and by source document for LlamaIndex) take the texts out of
    every answer."""
    from vearch_tpu_torch.sdk.client import VearchClient
    from vearch_tpu_torch.sdk.integrations.langchain_vearch_tpu import (
        VearchTpuVectorStore,
    )
    from vearch_tpu_torch.sdk.integrations.llamaindex_vearch_tpu import (
        TextNode, VearchTpuLlamaVectorStore, VectorStoreQuery,
    )

    n = INTEGRATION_TEXTS
    texts = [f"text {i} of the process phase" for i in range(n)]
    probe = [0, 7, 123, n - 1]
    out = {"texts": n}
    t0 = time.monotonic()
    lc = VearchTpuVectorStore(VearchClient(addr), "lc", "texts",
                              toy_embedding)
    ids = lc.add_texts(texts, metadatas=[{"i": i} for i in range(n)],
                       ids=[f"t{i}" for i in range(n)])
    check(ids == [f"t{i}" for i in range(n)], f"LangChain ids {ids[:4]}")
    top = {i: lc.similarity_search_with_score(texts[i], k=3) for i in probe}
    check(all(top[i][0][0].metadata["_id"] == f"t{i}"
              and top[i][0][0].page_content == texts[i] for i in probe),
          f"LangChain top hits {top}")
    again = VearchTpuVectorStore(VearchClient(addr), "lc", "texts",
                                 toy_embedding)
    check(again.similarity_search(texts[7], k=1)[0].metadata["_id"] == "t7",
          "a second LangChain store on the existing space")
    lc.delete([f"t{i}" for i in probe])
    left = {i: [d.metadata["_id"] for d in lc.similarity_search(texts[i], k=3)]
            for i in probe}
    check(not {f"t{i}" for i in probe} & {x for v in left.values()
                                           for x in v},
          f"LangChain deleted texts still served: {left}")
    out["langchain"] = {"added": len(ids), "top_hits": {
        str(i): top[i][0][0].metadata["_id"] for i in probe},
        "top_scores": {str(i): top[i][0][1] for i in probe},
        "deleted": len(probe), "after_delete": left,
        "seconds": time.monotonic() - t0}
    t0 = time.monotonic()
    emb = toy_embedding(texts)
    li = VearchTpuLlamaVectorStore(VearchClient(addr), "li", "nodes",
                                   dimension=INTEGRATION_DIM)
    nodes = []
    for i in range(n):
        node = TextNode(text=texts[i], id_=f"n{i}", embedding=emb[i],
                        metadata={"i": i})
        node.ref_doc_id = f"doc{i // 10}"
        nodes.append(node)
    added = li.add(nodes)
    check(added == [f"n{i}" for i in range(n)], f"LlamaIndex ids {added[:4]}")
    res = {i: li.query(VectorStoreQuery(query_embedding=emb[i],
                                        similarity_top_k=3)) for i in probe}
    check(all(res[i].ids[0] == f"n{i}"
              and res[i].nodes[0].get_content() == texts[i] for i in probe),
          f"LlamaIndex top hits { {i: r.ids for i, r in res.items()} }")
    li.delete("doc0")  # n0 .. n9
    li.delete_nodes([f"n{n - 1}"])
    gone = {f"n{i}" for i in range(10)} | {f"n{n - 1}"}
    after = {i: li.query(VectorStoreQuery(query_embedding=emb[i],
                                          similarity_top_k=3)).ids
             for i in probe}
    check(not gone & {x for v in after.values() for x in v},
          f"LlamaIndex deleted nodes still served: {after}")
    out["llamaindex"] = {"added": len(added), "top_hits": {
        str(i): res[i].ids[0] for i in probe}, "deleted": len(gone),
        "after_delete": after, "seconds": time.monotonic() - t0}
    return out


def phase_processes(dev, base, queries, ref) -> dict:
    """cloud/smoke_torch.py's topology on the card: 3 masters, 2 routers
    and 3 partition servers, each `python -m vearch_tpu_torch` in its own
    process, the servers started without `--device` (each on the card).
    phase_cluster's space, rows and requests (`ref`: its routed ids,
    dispatch tags, ingest rate and searches under a writer); ingest
    through both routers at once; the searches; a search under a writer;
    kill -9 of partition 0's leader under a writer, every acked id read
    back; the killed server restarted on its data dir (WAL replay, raft
    catch-up); kill -9 of the metadata leader; an S3 backup round trip;
    the doctor in its own process. The kernels' launch counters live in
    the child processes: the evidence of their paths is each search's
    dispatch tags on engines whose device is the card."""
    import threading

    from vearch_tpu_torch.cluster import rpc
    from vearch_tpu_torch.engine.types import MetricType
    from vearch_tpu_torch.sdk.client import VearchClient

    smoke = smoke_torch()
    n, d = PROCESS_ROWS, base.shape[1]
    rows = base[:n]
    cats = engine_docs(rows, seed=12)[0]
    truth = exact_topk(dev, queries, rows, MetricType.L2)
    same_rows = ref["rows"] == n
    out, times = {"rows": n, "reduced": REDUCED["processes"],
                  "card": nvidia_smi()}, {}
    data_dir = tempfile.mkdtemp(prefix="vearch_chip_procs_")
    roles = smoke.Roles(os.path.join(data_dir, "logs"))
    s3 = smoke.MockS3()
    t_phase = time.monotonic()
    ok = False

    def step(name):
        print(f"processes: {name} at {time.monotonic() - t_phase:.1f}s",
              flush=True)

    try:
        # one server alone first: where its device bytes go
        census = process_census()
        times["census"] = census["wall_s"]
        out["census"] = {k: census[k] for k in (
            "rows", "clients", "torch", "cuda", "card", "sampler", "cleared",
            "threads", "seconds", "wall_s")}
        out["census"]["by_stack"] = [
            {k: g[k] for k in ("stack", "bytes", "blocks", "sizes")}
            for g in census["by_stack"][:12]]
        print("processes_census " + json.dumps(out["census"]), flush=True)
        step("census")

        # the topology; nvidia-smi's contexts before and after each step
        contexts = {"before": compute_apps()}
        t0 = time.monotonic()
        # no --device: each partition server takes the card, or fails the
        # phase; both routers serve gRPC where grpcio and protobuf exist
        grpc_on = not smoke.grpc_missing()
        gports = smoke.free_ports(2) if grpc_on else None
        masters = smoke.start_topology(roles, data_dir, [], gports)
        times["start"] = time.monotonic() - t0
        contexts["started"] = compute_apps()
        out["banner_s"] = dict(roles.banner_s)
        ps_names = [f"ps{i + 1}" for i in range(3)]
        node_of = {name: int(roles.banners[name].split()[2].rstrip(":"))
                   for name in ps_names}
        ps_addrs = {node_of[name]: roles.addrs[name] for name in ps_names}
        r1 = VearchClient(roles.addrs["router1"])
        r2 = VearchClient(roles.addrs["router2"])
        cls = (r1, r2)
        r1.create_database("db")
        r1.create_space("db", cluster_space(d))
        step("started")

        # ingest through both routers at once, one client thread each
        def send(cl, lo, hi):
            for i in range(lo, hi, CLUSTER_BATCH):
                cl.upsert("db", "s", [{"_id": f"d{j}", "emb": rows[j],
                                       "cat": int(cats[j])}
                                      for j in range(i, min(i + CLUSTER_BATCH,
                                                            hi))])

        t0 = time.monotonic()
        with ThreadPoolExecutor(2) as pool:
            for fut in [pool.submit(send, cl, lo, lo + n // 2)
                        for cl, lo in zip(cls, (0, n // 2))]:
                fut.result()
        times["ingest"] = time.monotonic() - t0
        out["ingest"] = {"docs_per_s": n / times["ingest"],
                         "in_process_docs_per_s": ref["ingest_docs_per_s"]}
        out["doc_counts"], _ = wait_process_counts(r1, ps_addrs, n)
        print("processes_ingest " + json.dumps(out["ingest"]), flush=True)
        out["build"] = process_build(r1, ps_addrs)
        times["build"] = out["build"]["total_s"]
        step("built")

        # every partition server on the card: its /metrics page's live
        # device bytes under a cuda label, its engines' contexts
        out["device_bytes"] = {name: ps_device_bytes(roles.addrs[name])
                               for name in ps_names}
        for name, by in out["device_bytes"].items():
            check(any(k.startswith("cuda") and v > 0 for k, v in by.items()),
                  f"{name} holds no live bytes on the card: {by}")
        contexts["built"] = compute_apps()
        out["contexts"] = contexts
        out["contexts_opened"] = {
            "masters_routers_ps_started": len(contexts["started"])
            - len(contexts["before"]),
            "after_ingest_and_build": len(contexts["built"])
            - len(contexts["before"])}
        out["pids"] = {name: p.pid for name, p in roles.procs.items()}
        print("processes_contexts " + json.dumps(
            {k: out[k] for k in ("contexts", "contexts_opened", "pids",
                                 "device_bytes")}), flush=True)
        check(out["contexts_opened"]["after_ingest_and_build"] >= 3,
              f"fewer than 3 new contexts on the card: {contexts}")

        # the searches, each beside phase_cluster's ids for the request
        t0 = time.monotonic()
        searches, routed = {}, {}
        for name, params in CLUSTER_REQUESTS.items():
            res, routed[name] = process_path(cls, queries, params, truth)
            if same_rows:
                res["rows_differing_in_process"] = rows_differing(
                    routed[name], ref["ids"][name])
            searches[name] = res
            print(f"processes_search {name} " + json.dumps(res), flush=True)
        check(searches["full_rerank512"]["recall_at_10"] >= 0.95,
              "routed recall@10 at rerank 512 "
              f"{searches['full_rerank512']['recall_at_10']} < 0.95")
        router_search(r1, queries[:1], CLUSTER_GATED)
        b1 = [router_search(cls[i % 2], queries[i:i + 1], CLUSTER_GATED)[1]
              for i in range(CLUSTER_B1)]
        searches["b1"] = {
            "params": CLUSTER_GATED, "searches": CLUSTER_B1,
            "p50_ms": float(np.percentile(b1, 50)),
            "p99_ms": float(np.percentile(b1, 99))}
        # the kernels' paths: dispatch tags as phase_cluster's
        profiles, tags = {}, {}
        for name in ("full_rerank512", "probe_rerank512"):
            profiles[name], tags[name] = profiled_tags(
                r1, queries, CLUSTER_REQUESTS[name])
            check(tags[name] == ref["tags"][name],
                  f"{name} dispatched {tags[name]}, in process "
                  f"{ref['tags'][name]}")
        searches["profile_rerank512"] = profiles["full_rerank512"]
        out["dispatch_tags"] = tags
        out["searches"] = searches
        print("processes_search b1 " + json.dumps(searches["b1"])
              + " tags " + json.dumps(tags), flush=True)

        # gated searches through router1 while router2 re-upserts
        # CLUSTER_WRITES docs (cluster_concurrent_writer's bounded writer)
        errors: list = []
        writes = min(CLUSTER_WRITES, n // 500 * 500)

        def rewriter():
            try:
                for lo in range(0, writes, 500):
                    r2.upsert("db", "s", [{"_id": f"d{i}", "emb": rows[i],
                                           "cat": int(cats[i])}
                                          for i in range(lo, lo + 500)])
            except Exception as e:  # reported and failed below
                errors.append(repr(e))

        w = threading.Thread(target=rewriter, name="process-writer",
                             daemon=True)
        t1 = time.monotonic()
        w.start()
        wtimes, wrecalls = [], []
        while w.is_alive() or not wtimes:
            ids, ms = router_search(r1, queries, CLUSTER_GATED)
            wtimes.append(ms)
            wrecalls.append(cluster_recall(ids, truth))
        w.join(PROCESS_DEADLINE_S)
        check(not w.is_alive() and not errors,
              f"the writer failed or hung: {errors}")
        out["writer"] = {
            "params": CLUSTER_GATED, "rewritten_docs": writes,
            "writes_s": time.monotonic() - t1, "searches": len(wtimes),
            "search_ms": float(np.median(wtimes)), "all_ms": wtimes,
            "in_process_ms": ref["writer_ms"],
            "recall_at_10": min(wrecalls)}
        wait_process_counts(r1, ps_addrs, n)
        check(out["writer"]["recall_at_10"] >= 0.95,
              f"recall@10 under a writer {out['writer']['recall_at_10']}")
        print("processes_writer " + json.dumps(out["writer"]), flush=True)
        times["searches"] = time.monotonic() - t0
        step("searched")

        # gRPC through both routers, beside REST (or which tool is missing)
        t0 = time.monotonic()
        if grpc_on:
            new_rows = base[n + PROCESS_FAILOVER_WRITES:][:GRPC_DOCS]
            out["grpc"] = {
                f"router{i + 1}": process_grpc(
                    f"127.0.0.1:{port}", cl, ps_addrs, queries, new_rows,
                    tags["full_rerank512"])
                for i, (port, cl) in enumerate(zip(gports, cls))}
            wait_process_counts(r1, ps_addrs, n)
        else:
            out["grpc"] = {"not_run": "missing on this machine: "
                                      + " and ".join(smoke.grpc_missing())}
        times["grpc"] = time.monotonic() - t0
        print("processes_grpc " + json.dumps(out["grpc"]), flush=True)

        # the framework integrations over router1
        t0 = time.monotonic()
        out["integrations"] = process_integrations(roles.addrs["router1"])
        times["integrations"] = time.monotonic() - t0
        print("processes_integrations " + json.dumps(out["integrations"]),
              flush=True)
        step("grpc and integrations")

        # kill -9 of partition 0's leader while a writer adds new docs,
        # retrying each batch until it is acked
        t0 = time.monotonic()
        part0 = min(r1.get_space("db", "s")["partitions"],
                    key=lambda p: p["id"])
        dead = part0["leader"]
        victim = next(k for k, v in node_of.items() if v == dead)
        fo = {"partition": part0["id"], "killed": victim,
              "killed_node": dead,
              "placement_before": r1.get_space("db", "s")["partitions"]}
        acked, acks, werr = [], [], []
        total = n + PROCESS_FAILOVER_WRITES

        def writer():
            deadline = time.monotonic() + 2 * PROCESS_DEADLINE_S
            for lo in range(n, total, 500):
                docs = [{"_id": f"d{j}", "emb": base[j], "cat": j % 100}
                        for j in range(lo, lo + 500)]
                while True:
                    try:
                        r2.upsert("db", "s", docs)
                        break
                    except rpc.RpcError as e:
                        if time.monotonic() > deadline:
                            werr.append(repr(e))
                            return
                        time.sleep(0.1)
                acked.extend(dd["_id"] for dd in docs)
                acks.append(time.monotonic())

        w = threading.Thread(target=writer, name="failover-writer",
                             daemon=True)
        w.start()
        while len(acked) < PROCESS_FAILOVER_WRITES // 5 and w.is_alive():
            check(time.monotonic() - t0 < PROCESS_DEADLINE_S,
                  "the failover writer acked nothing")
            time.sleep(0.05)
        t_kill = time.monotonic()
        roles.kill(victim)
        del ps_addrs[dead]
        leader = dead
        while leader in (dead, -1):
            check(time.monotonic() - t_kill < PROCESS_DEADLINE_S,
                  f"no new leader for partition {part0['id']}")
            time.sleep(0.1)
            leader = next(p for p in r1.get_space("db", "s")["partitions"]
                          if p["id"] == part0["id"])["leader"]
        fo["new_leader"] = leader
        fo["leader_promoted_s"] = time.monotonic() - t_kill
        while True:
            try:
                router_search(r1, queries[:1], CLUSTER_GATED)
                break
            except rpc.RpcError:
                check(time.monotonic() - t_kill < PROCESS_DEADLINE_S,
                      "no search served after the kill -9")
                time.sleep(0.1)
        fo["first_search_served_s"] = time.monotonic() - t_kill
        w.join(2 * PROCESS_DEADLINE_S)
        check(not w.is_alive() and not werr,
              f"the failover writer failed or hung: {werr}")
        later = [a for a in acks if a > t_kill]
        fo["first_write_acked_s"] = later[0] - t_kill if later else None
        fo["acked_writes"] = len(acked)
        check(len(acked) == PROCESS_FAILOVER_WRITES,
              f"{len(acked)} of {PROCESS_FAILOVER_WRITES} writes acked")
        got = set()
        for lo in range(0, len(acked), 1000):
            chunk = acked[lo:lo + 1000]
            got |= {doc["_id"] for doc in r1.query(
                "db", "s", document_ids=chunk, limit=len(chunk))}
        fo["acked_missing"] = sorted(set(acked) - got)[:10]
        check(not fo["acked_missing"],
              f"ACKED WRITES LOST after kill -9: {fo['acked_missing']}")
        fo["doc_counts_two_replicas"] = process_counts(
            ps_addrs, {p["id"] for p in fo["placement_before"]})
        truth = exact_topk(dev, queries, base[:total], MetricType.L2)
        time.sleep(1.0)  # the refresh loops absorb the last writes
        res, ids = process_path(cls, queries, CLUSTER_GATED, truth)
        fo["search"] = res
        fo["tags"] = profiled_tags(r1, queries, CLUSTER_GATED)[1]
        check(res["recall_at_10"] >= 0.95,
              f"recall@10 after the kill -9 {res['recall_at_10']} < 0.95")
        check(fo["tags"] == ref["tags"]["full_rerank512"],
              f"after the kill -9 the full scan dispatched {fo['tags']}")
        out["failover"] = fo
        times["failover"] = time.monotonic() - t0
        print("processes_failover " + json.dumps(fo), flush=True)
        step("failed over")

        # the killed server again, on its data dir: WAL replay, then the
        # leaders' catch-up; what the master did with its replicas meanwhile
        t0 = time.monotonic()
        wal = {"placement_meanwhile": r1.get_space("db", "s")["partitions"],
               "servers_meanwhile": sorted(
                   s["node_id"] for s in rpc.call(masters, "GET",
                                                  "/servers")["servers"])}
        roles.restart(victim)
        wal["banner_s"] = roles.banner_s[victim]
        wal["first_banner_s"] = out["banner_s"][victim]
        check(roles.banners[victim].startswith(f"ps node {dead}:"),
              f"the restarted server is not node {dead}: "
              f"{roles.banners[victim]}")
        ps_addrs[dead] = roles.addrs[victim]
        wal["doc_counts"], wal["catch_up_s"] = wait_process_counts(
            r1, ps_addrs, total, deadline_s=2 * PROCESS_DEADLINE_S)
        wal["placement_after"] = r1.get_space("db", "s")["partitions"]
        # its engines reopen from the last flush and replay the tail, and
        # come back unindexed (status 1), as a moved replica does: build
        stats = rpc.call(roles.addrs[victim], "GET", "/ps/stats")
        wal["restarted_status"] = {pid: p["status"] for pid, p in
                                   stats["partitions"].items()}
        t1 = time.monotonic()
        for pid, status in wal["restarted_status"].items():
            if status != 3:
                rpc.call(roles.addrs[victim], "POST", "/ps/index/build",
                         {"partition_id": int(pid)}, timeout=900.0)
        wal["rebuild_s"] = time.monotonic() - t1
        out["wal_restart"] = wal
        times["wal_restart"] = time.monotonic() - t0
        print("processes_wal_restart " + json.dumps(wal), flush=True)
        step("restarted")

        # kill -9 of the metadata leader: both routers keep serving, and a
        # new leader is elected
        t0 = time.monotonic()
        mleader = smoke.meta_leader(roles, masters)
        check(mleader is not None, "no metadata leader before the kill")
        roles.kill(mleader)
        mk = {"killed": mleader, "served": {}}
        for name, cl in zip(("router1", "router2"), cls):
            while True:
                try:
                    ids, ms = router_search(cl, queries, CLUSTER_GATED)
                    break
                except rpc.RpcError:
                    check(time.monotonic() - t0 < PROCESS_DEADLINE_S,
                          f"{name} stopped serving after the master kill")
                    time.sleep(0.1)
            mk["served"][name] = {"after_s": time.monotonic() - t0,
                                  "search_ms": ms,
                                  "recall_at_10": cluster_recall(ids, truth)}
            check(mk["served"][name]["recall_at_10"] >= 0.95,
                  f"{name} recall@10 after the master kill")
        while smoke.meta_leader(roles, masters) in (None, mleader):
            check(time.monotonic() - t0 < PROCESS_DEADLINE_S,
                  "no new metadata leader elected")
            time.sleep(0.1)
        mk["new_leader"] = smoke.meta_leader(roles, masters)
        mk["elected_s"] = time.monotonic() - t0
        out["master_kill"] = mk
        times["master_kill"] = time.monotonic() - t0
        print("processes_master_kill " + json.dumps(mk), flush=True)
        step("master killed")

        # S3: backup version 1, delete every doc, restore, the same ids
        t0 = time.monotonic()
        erows, equeries = elastic_data(d, seeds=PROCESS_S3_ROWS)
        erows = erows[:PROCESS_S3_ROWS]
        r1.create_space("db", elastic_space(d))  # a mutation: new leader
        for lo in range(0, PROCESS_S3_ROWS, CLUSTER_BATCH):
            r1.upsert("db", "e", [{"_id": f"d{j}", "emb": erows[j]}
                                  for j in range(lo, min(
                                      lo + CLUSTER_BATCH, PROCESS_S3_ROWS))])
        wait_process_counts(r1, ps_addrs, PROCESS_S3_ROWS, space="e")
        s3_out = {"rows": PROCESS_S3_ROWS,
                  "build": process_build(r1, ps_addrs, space="e")}
        etruth = exact_topk(dev, equeries, erows, MetricType.L2)
        before, s3_out["search_ms"] = router_search(r1, equeries,
                                                    CLUSTER_GATED, space="e")
        s3_out["recall_at_10"] = cluster_recall(before, etruth)
        check(s3_out["recall_at_10"] >= 0.95,
              f"e recall@10 {s3_out['recall_at_10']} < 0.95")
        spec = {"type": "s3", "endpoint": s3.addr, "bucket": "bk",
                "access_key": "ak", "secret_key": "sk"}
        t1 = time.monotonic()
        res = rpc.call(masters, "POST", "/backup/dbs/db/spaces/e",
                       {"command": "create", "store": spec}, timeout=600.0)
        s3_out["backup_s"] = time.monotonic() - t1
        check(res["version"] == 1, f"backup {res}")
        s3_out["objects"] = len(s3.objects)
        s3_out["bytes"] = sum(len(v) for v in s3.objects.values())
        for lo in range(0, PROCESS_S3_ROWS, CLUSTER_BATCH):
            r1.delete("db", "e", document_ids=[
                f"d{j}" for j in range(lo, min(lo + CLUSTER_BATCH,
                                               PROCESS_S3_ROWS))])
        wait_process_counts(r1, ps_addrs, 0, space="e")
        t1 = time.monotonic()
        res = rpc.call(masters, "POST", "/backup/dbs/db/spaces/e",
                       {"command": "restore", "store": spec, "version": 1},
                       timeout=600.0)
        s3_out["restore_s"] = time.monotonic() - t1
        check(sum(p["doc_count"] for p in res["partitions"])
              == PROCESS_S3_ROWS, f"restore {res}")
        s3_out["doc_counts"], _ = wait_process_counts(
            r1, ps_addrs, PROCESS_S3_ROWS, space="e")
        after, _ = router_search(r1, equeries, CLUSTER_GATED, space="e")
        s3_out["rows_differing"] = rows_differing(after, before)
        check(after == before, "ids after the restore differ in "
              f"{s3_out['rows_differing']} rows")
        out["s3"] = s3_out
        times["s3"] = time.monotonic() - t0
        print("processes_s3 " + json.dumps(s3_out), flush=True)
        step("s3 round trip")

        # the doctor, in its own process, against the masters' list, one
        # sampler period after the last request
        time.sleep(PROCESS_QUIET_S)
        t0 = time.monotonic()
        doc = subprocess.run(
            [sys.executable, "-m", "vearch_tpu_torch", "doctor",
             "--master", masters, "--json"], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        report = json.loads(doc.stdout)
        out["doctor"] = {
            "exit_code": doc.returncode,
            "checks": {ch["name"]: ch["ok"] for ch in report["checks"]},
            "violations": [v["name"] for v in report["violations"]],
            "seconds": time.monotonic() - t0}
        out["doctor"]["details"] = {v["name"]: v.get("detail")
                                    for v in report["violations"]}
        out["doctor"]["hbm_drift_fired"] = (
            "hbm_drift" in out["doctor"]["violations"])
        print("processes_doctor " + json.dumps(out["doctor"]), flush=True)
        # one server a process: each sampler holds its own process's
        # bytes against its own models and cuBLAS workspaces, so no
        # hbm_drift is explained here
        unexplained = sorted(set(out["doctor"]["violations"])
                             - (set(DOCTOR_EXPECTED) - {"hbm_drift"}))
        check(doc.returncode in (0, 1) and not unexplained,
              f"doctor exit {doc.returncode}: unexplained violations "
              f"{unexplained} ({out['doctor']['details']})")
        lint = next(ch for ch in report["checks"]
                    if ch["name"] == "lint_clean")
        check(lint["ok"] is True and not lint.get("skipped"),
              f"doctor lint_clean: {lint}")
        times["doctor"] = out["doctor"]["seconds"]
        ok = True
    finally:
        t0 = time.monotonic()
        roles.close()
        s3.stop()
        if not ok:
            print(roles.tails(), flush=True)
        shutil.rmtree(data_dir, ignore_errors=True)
        times["stop"] = time.monotonic() - t0
    out["seconds"] = times
    return out


def phase_cluster(dev, base, queries) -> tuple[dict, dict, tuple, dict]:
    """The port's cluster plane on the card: StandaloneCluster (master,
    router, 3 partition servers, no device argument: the card), driven
    through the port's SDK; then phase_elastic on the same cluster after
    its failover. Returns phase_elastic's (out, paths) third, its seconds
    out["seconds"]["elastic"], and fourth what phase_processes compares
    with: the routed ids of each request, the dispatch tags, the ingest
    rate and the search times under a writer."""
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
        out["reduced"] += (f" ({out['ingest_docs_per_s']:.0f} docs/s in this "
                           f"run: 1M rows would take "
                           f"{1e6 / out['ingest_docs_per_s']:.0f} s)")
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
        searches, routed = {}, {}
        for name, params in CLUSTER_REQUESTS.items():
            res, routed[name] = cluster_path(cl, queries, params, truth,
                                             kernels[name])
            res["engine_alone_ms"] = alone[name]["search_ms"]
            searches[name] = res
            paths[name] = res
            print(f"cluster_search {name} " + json.dumps(res), flush=True)
        before = routed["full_rerank512"]
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
        # and engines (profile: true), with every engine's rows on the
        # card; the full and probe paths' dispatch tags, which
        # phase_processes holds its partition servers to
        prof, tags = profiled_tags(cl, queries, CLUSTER_GATED)
        searches["profile_rerank512"] = prof
        print("cluster_profile " + json.dumps(prof), flush=True)
        out["dispatch_tags"] = {
            "full_rerank512": tags,
            "probe_rerank512": profiled_tags(
                cl, queries, CLUSTER_REQUESTS["probe_rerank512"])[1]}
        print("cluster_tags " + json.dumps(out["dispatch_tags"]), flush=True)
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

        t0 = time.monotonic()
        elastic = phase_elastic(dev, c, {
            "rows": n, "queries": queries, "truth": truth,
            "before": before}, base.shape[1])
        times["elastic"] = time.monotonic() - t0
    finally:
        t0 = time.monotonic()
        c.stop()
        shutil.rmtree(data_dir, ignore_errors=True)
        del c
        release_device_memory()
        times["stop"] = time.monotonic() - t0
    out["seconds"] = times
    # what phase_processes compares its routed searches with
    ref = {"rows": n, "ids": routed, "tags": out["dispatch_tags"],
           "ingest_docs_per_s": out["ingest_docs_per_s"],
           "writer_ms": cw["search"]["all_ms"]}
    return out, paths, elastic, ref


def _is_range(ev) -> bool:
    """Whether a profiler event is a record_function range (one of the
    program's spans) rather than a kernel. Raises where this torch's
    events do not say, since counting the ranges as kernels would
    inflate the device time without an error."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is None:
        raise RuntimeError(
            f"profiler event {ev.key!r} carries no is_user_annotation: "
            "the program's ranges cannot be told from kernels")
    return bool(flag)


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
        # a profiler range (the program's spans, `ranges`) shows on the
        # device too: not a kernel
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us
                and ev.key not in ranges and not _is_range(ev)):
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    res = {"wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms if wall_ms else 0.0,
           "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                   for ms, k, c in rows[:8]]}
    if ranges:
        # each range is read from its host side, which sums the device
        # time of the kernels launched inside it; its mirror on the
        # device's timeline has the same key and can lose its records
        got = {ev.key: getattr(ev, "device_time_total", 0.0) / 1e3
               for ev in prof.key_averages() if ev.key in ranges
               and ev.device_type == torch.autograd.DeviceType.CPU}
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


def run_lint(pkg: str) -> dict:
    """`python -m vearch_tpu_torch.tools.lint pkg` in its own process,
    from pkg's parent (so the lint that runs is pkg's own): its exit
    code, output and wall seconds."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "vearch_tpu_torch.tools.lint", pkg],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(pkg))
    return {"exit_code": out.returncode, "output": out.stdout + out.stderr,
            "seconds": time.monotonic() - t0}


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
            "blockmax_stage2": bms.blockmax_stage2_rescore,
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
    wide = phase_wide_kernels(dev)
    release_device_memory()
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
    mesh, mesh_paths = phase_mesh(dev, base, queries, truth)
    print("mesh " + json.dumps(mesh), flush=True)
    print(f"phase mesh: {time.monotonic() - t0:.1f}s", flush=True)
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
    cluster, cluster_paths, (elastic, elastic_paths), cluster_ref = \
        phase_cluster(dev, base, queries)
    print("cluster " + json.dumps(cluster), flush=True)
    print("elastic " + json.dumps(elastic), flush=True)
    elastic_s = cluster["seconds"]["elastic"]
    print(f"phase cluster: {time.monotonic() - t0 - elastic_s:.1f}s",
          flush=True)
    print(f"phase elastic: {elastic_s:.1f}s", flush=True)
    t0 = time.monotonic()
    processes = phase_processes(dev, base, queries, cluster_ref)
    print("processes " + json.dumps(processes), flush=True)
    print(f"phase processes: {time.monotonic() - t0:.1f}s", flush=True)
    footprint_table()
    paths = dict(family, engine=engine_paths, **disk_paths, **runtime_paths,
                 **storage_paths, mesh=mesh_paths, cluster=cluster_paths,
                 elastic=elastic_paths)
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
         "bound_by": res["bound_by"], "library_ms": res["library_ms"],
         # the gist1m-ivfpq.batch-full cell's shape: the 64-query tile
         "d960_case": {k: wide[k] for k in (
             "B", "N_pad", "d", "query_tile", "launches", "ms", "plain_ms",
             "library_ms", "bound_ms", "bound_by", "mirror_bytes",
             "mirror_bytes_at_peak_ms")}},
        {"name": "blockmax_stage2", "route": "cuda",
         "design": "the stage-1 mainloop (wgmma bf16, int8 rows converted "
                   "in registers) over the blocks its query tile "
                   "selected; the epilogue stores each selected "
                   "query's f32 scores in the plain version's layout",
         "source": "vearch_tpu_torch/csrc/blockmax_scan.cu",
         "replaces": "none (XLA ops in vearch_tpu/ops/pallas_kernels.py "
                     "_stage2)",
         "launches": main_res["launches"]["blockmax_stage2"],
         "launches_by_path": launches_by_path(
             main_res, paths, "blockmax_stage2"),
         **{k: res["stage2"][k] for k in (
             "worst_share_of_bound", "rescore_ms", "stage2_ms", "topk_ms",
             "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tile_block_pairs_computed", "peak_bytes")},
         "d960_case": dict(
             {k: wide[k] for k in ("B", "N_pad", "d", "query_tile",
                                   "launches")},
             **{k: wide["stage2"][k] for k in (
                 "rescore_ms", "stage2_ms", "topk_ms", "plain_ms",
                 "library_ms", "bound_ms", "bound_by",
                 "tile_block_pairs_computed", "mirror_bytes",
                 "peak_bytes")})},
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
