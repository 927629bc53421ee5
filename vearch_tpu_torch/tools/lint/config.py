"""Project policy knobs for vearch-lint.

Everything path-shaped is a POSIX path *suffix* matched against the
scanned file path, so the linter works from any working directory.

The port's copy of vearch_tpu/tools/lint/config.py: the path tables are
re-rooted at vearch_tpu_torch/, and VL101/VL501 and VL102/VL502 also
read PyTorch's constructs (TORCH_DISPATCH_*, TORCH_SYNC_*).
"""

from __future__ import annotations

# -- VL101 dispatch hygiene ---------------------------------------------------
# Packages allowed to create device dispatches (jax.jit / pallas_call /
# pmap / shard_map). Everything else — the cluster plane above all —
# must call into these layers instead of tracing its own programs, or
# the perf model's DOCUMENTED_DISPATCHES stops being the whole story.
DISPATCH_PACKAGES = (
    "vearch_tpu_torch/ops/",
    "vearch_tpu_torch/engine/",
    # the mesh data plane: shard_map programs + tail-append writers are
    # first-class dispatch sources, registered in the perf model's jit
    # registry like every ops/ program
    "vearch_tpu_torch/parallel/",
    # the tiered storage engine: the staged slab scatter is the one
    # device program of the subsystem, registered in the jit registry
    "vearch_tpu_torch/tiering/",
)

# Names whose call or decorator use counts as creating a dispatchable
# program. Attribute form (jax.jit) and bare imported form (jit) both.
DISPATCH_CONSTRUCTS = {
    "jit", "pmap", "pallas_call", "shard_map", "xla_computation",
}

# The port's device programs: the perf model's program registry
# (ops/perf_model.register_op), a CUDA library build (ops/_cuda_build
# .CudaLibrary), and PyTorch's compiled or captured programs. Matched by
# last name...
TORCH_DISPATCH_NAMES = {"register_op", "CudaLibrary", "CUDAGraph",
                        "load_inline"}
# ...and, where the last name alone is generic (`re.compile`,
# `json.load`), as a dotted suffix of the call's name. HostExtension
# builds host C++ (native/) and is not a dispatch.
TORCH_DISPATCH_DOTTED = ("torch.compile", "jit.script", "jit.trace",
                         "cuda.graph", "cpp_extension.load")

# -- VL102 host-device sync points in serving paths ---------------------------
# (path suffix, function qualname) pairs marking the hot serving path.
# Inside these functions a host sync (block_until_ready / device_get /
# .item() / np.asarray materialisation) stalls the request on device
# completion and must carry an inline allow[host-sync] justification.
SERVING_PATH_FUNCTIONS = {
    ("vearch_tpu_torch/engine/engine.py", "Engine.search"),
    ("vearch_tpu_torch/engine/engine.py", "Engine._search_direct"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._h_search"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._do_search"),
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._h_search"),
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._search_impl"),
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._search_scatter"),
}

HOST_SYNC_METHODS = {"block_until_ready", "item"}
HOST_SYNC_CALLS = {"device_get", "asarray", "array"}

# PyTorch's host syncs besides `.item()` and np.asarray/np.array: a
# device-to-host copy (`.cpu()`), any `.synchronize()` (torch.cuda's,
# an event's, a stream's), and a materialisation (`.tolist()`,
# `.numpy()`) whose receiver is visibly a tensor: a chain that reaches
# a `torch.` call or one of TORCH_TENSOR_METHODS. A numpy array's
# `.tolist()` is host work and does not count.
TORCH_SYNC_METHODS = {"cpu"}
TORCH_SYNC_ANY_ARGS = {"synchronize"}
TORCH_MATERIALIZE_METHODS = {"tolist", "numpy"}
TORCH_TENSOR_METHODS = {"cpu", "cuda", "detach"}

# -- VL203 wall-clock discipline ---------------------------------------------
# time.time() is banned for anything measured or compared (latency,
# deadlines, TTLs): wall clocks step under NTP and the measurement
# silently corrupts. time.monotonic() is the default; genuinely
# wall-anchored stamps (span epochs, persisted create times) carry an
# inline allow[wall-clock] with the reason.

# -- VL302 swallowed exceptions ----------------------------------------------
# Modules whose apply/commit paths must never swallow an exception
# silently: a broad handler there needs a raise, a log call, or an
# internal_error() count before it may continue.
CRITICAL_ERROR_MODULES = (
    "vearch_tpu_torch/cluster/raft.py",
    "vearch_tpu_torch/cluster/wal.py",
)

LOG_CALL_NAMES = {
    "debug", "info", "warning", "error", "exception", "critical", "log",
}
ERROR_COUNT_CALLS = {"internal_error", "inc"}

# -- VL103 shape-bucket drift -------------------------------------------------
# The continuous-batching scheduler only stays zero-retrace if every
# serving-path batch shape comes from ONE declared grid. The canonical
# declaration lives in BUCKET_DECL_FILE; lint pins its values here so
# the grid cannot change without a conscious policy edit, and flags any
# OTHER module re-declaring bucket/tier literals instead of importing
# the perf model's.
BUCKET_DECL_FILE = "vearch_tpu_torch/ops/perf_model.py"
BUCKET_ROW_TIERS = (8, 64, 256, 1024)
BUCKET_FETCH_K_TIERS = (16, 64, 256, 1024)
# module-level names matched (by suffix) as shape-tier declarations
BUCKET_NAME_SUFFIXES = ("_BUCKETS", "_TIERS")

# -- VL104 tenant attribution -------------------------------------------------
# Serving-path files where billable counter mutations must carry space
# attribution (docs/ACCOUNTING.md): ISSUE 17 made every serving-path
# cost tenant-attributable, and a new .inc() that forgets the space
# label silently un-attributes a whole failure class. Matched by path
# suffix, like SERVING_PATH_FUNCTIONS.
VL104_SERVING_FILES = (
    "vearch_tpu_torch/cluster/ps.py",
    "vearch_tpu_torch/cluster/router.py",
)
# counter attributes whose .inc() calls are billable events: they count
# per-tenant failures (kills, sheds) and must pass a space label
VL104_BILLABLE_COUNTERS = ("_killed_total", "_shed_total")

# -- VL105 quality staleness --------------------------------------------------
# The search-quality truth layer (docs/QUALITY.md) scores served
# results against fresh exact ground truth. Any function that replaces
# the serving index (an engine build/rebuild call) must also call the
# monitor's staleness hook, or queued shadow samples get scored against
# a snapshot that no longer serves — phantom recall loss. Matched by
# path suffix in the files that own index mutation.
VL105_QUALITY_FILES = (
    "vearch_tpu_torch/cluster/ps.py",
    # the engine owns the bit-plane / mirror rebuild paths directly:
    # rebuild_index replaces every compressed serving tier in place,
    # so engine-embedded users (bench, SDK-local) need the hook too
    "vearch_tpu_torch/engine/engine.py",
)
# attribute-call names that replace index contents wholesale
VL105_INDEX_MUTATORS = ("build_index", "rebuild_index")
# the QualityMonitor staleness hook every such function must also call
VL105_STALENESS_HOOK = "note_index_mutation"

# -- VL201 lock discipline ----------------------------------------------------
# Methods treated as mutations when called on a guarded attribute.
MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "move_to_end",
    "appendleft", "popleft",
}

# -- VL501–VL504 interprocedural serving-path analysis ------------------------
# Entry points the whole-program call graph is rooted at:
# (path suffix, function qualname, kind). "search" marks the
# latency-critical read path (VL502 blocking and VL504 deadline rules
# apply); "write" marks ingest/apply paths (VL501 dispatch hygiene
# only — writes tolerate I/O by design, raft/WAL *are* I/O).
INTERPROC_ENTRY_POINTS = (
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._h_search", "search"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._h_search", "search"),
    ("vearch_tpu_torch/engine/engine.py", "Engine.search", "search"),
    # the continuous-batching dispatch thread serves queued searches
    ("vearch_tpu_torch/engine/batching.py", "BatchScheduler._loop", "search"),
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._h_upsert", "write"),
    ("vearch_tpu_torch/cluster/router.py", "RouterServer._h_delete", "write"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._h_upsert", "write"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._h_delete", "write"),
    ("vearch_tpu_torch/engine/engine.py", "Engine.upsert", "write"),
    ("vearch_tpu_torch/engine/engine.py", "Engine.delete", "write"),
    # raft/WAL observer callbacks run on the apply thread; their
    # closures are reachable through the closure rule
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._raft_observer", "write"),
    ("vearch_tpu_torch/cluster/ps.py", "PSServer._wal_observer", "write"),
)

# Ubiquitous method names whose name-based fan-out would connect every
# class in the project; calls on untyped receivers with these names
# land in the unresolved bucket instead of fanning out.
FANOUT_STOPLIST = {
    "get", "put", "pop", "add", "append", "extend", "remove", "discard",
    "clear", "update", "setdefault", "items", "keys", "values", "copy",
    "close", "start", "stop", "join", "wait", "set", "reset", "acquire",
    "release", "read", "write", "send", "recv", "open", "flush", "load",
    "save", "notify", "notify_all", "count", "index", "sort", "split",
    "strip", "encode", "decode", "format", "lower", "upper", "popleft",
    "appendleft", "info", "debug", "warning", "error", "exception",
}

# Layers that sit ABOVE the cluster (clients of it): excluded from
# name-based fan-out so VearchClient.search cannot be mistaken for a
# callee of Engine.search.
INTERPROC_FANOUT_EXCLUDE = ("vearch_tpu_torch/sdk/",)

# Packages whose host-device syncs are their own business (VL502's
# host-sync subset): the device layers and the CPU-side index/scalar
# data structures materialise arrays by design. The blocking-I/O
# subset is exempt NOWHERE — an open()/sleep()/socket reachable from
# a search handler needs a justification wherever it lives.
VL502_SYNC_EXEMPT_PACKAGES = DISPATCH_PACKAGES + (
    "vearch_tpu_torch/index/",
    "vearch_tpu_torch/scalar/",
)

# Blocking primitives: bare-name calls that resolve to nothing in the
# project (true builtins/externals)...
VL502_BLOCKING_BARE = {"open", "urlopen"}
# ...module-qualified calls (module -> functions; None = any)...
VL502_BLOCKING_MODULES = {
    "time": {"sleep"},
    "socket": None,
    "select": None,
    "subprocess": {"run", "Popen", "check_call", "check_output", "call"},
    "mmap": {"mmap"},
    "os": {"read", "write", "fsync", "system", "popen", "sendfile"},
    "urllib.request": {"urlopen"},
    "requests": None,
    "numpy": {"memmap"},
}
# ...and methods on receivers the resolver could not type (file/socket
# handles reaching the serving path through parameters).
VL502_BLOCKING_METHODS = {
    "recv", "recv_into", "sendall", "accept", "connect", "readinto",
    "readline", "readlines", "madvise",
}

# Known mmap page-fault gather frames: functions whose subscript
# gathers fault NVMe pages on the request thread (no call for the
# analyzer to see). Serving-path reachability of these frames is a
# VL502 finding unless the def line carries the justification.
VL502_PAGEFAULT_FUNCS = (
    ("vearch_tpu_torch/tiering/ram_tier.py", "HostRowCache.get_rows"),
    ("vearch_tpu_torch/tiering/ram_tier.py", "HostRamSlabTier.get"),
    ("vearch_tpu_torch/tiering/readahead.py", "advise_rows"),
)

# -- VL504 deadline propagation ----------------------------------------------
# RPC/HTTP boundary calls on the search serving path: every one must
# thread the request deadline downstream (an explicit timeout= derived
# from the armed RequestContext, or a body dict that carries
# deadline_ms for the receiving node to arm its own context).
VL504_BOUNDARY_SUFFIXES = ("cluster.rpc:call",)
VL504_BOUNDARY_DOTTED = ("rpc.call",)
VL504_DEADLINE_KWARGS = {"timeout", "deadline_ms", "deadline"}
VL504_BODY_DEADLINE_KEY = "deadline_ms"
