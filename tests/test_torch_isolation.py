"""vearch_tpu_torch stands alone: importing every one of its modules,
serving a bf16 disk store under DISKANN, and serving an int4-mirror and
an OPQ IVFPQ index under the runtime layer (accountant, flight recorder,
quality monitor, device sampler), and serving a CPU cluster (master,
router, partition servers) through the port's SDK pulls in neither JAX,
nor anything of vearch_tpu, nor ml_dtypes (the GPU machine has none), and
its entry points refuse to run on the CPU unless asked to."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import vearch_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    vearch_tpu_torch.__path__, "vearch_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "vearch_tpu" or m.startswith("vearch_tpu.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
from vearch_tpu_torch.engine.engine import Engine
from vearch_tpu_torch.engine.types import (DataType, FieldSchema,
                                           IndexParams, MetricType,
                                           TableSchema)
schema = TableSchema("t", [FieldSchema(
    "emb", DataType.VECTOR, dimension=8,
    index=IndexParams("IVFPQ", MetricType.L2, {"nsubvector": 2}))])
try:
    Engine(schema)
    refused = False
except RuntimeError:
    refused = True
Engine(schema, device="cpu")
# the disk tier end to end: a bf16 disk store under DISKANN
import tempfile
import numpy as np
disk = TableSchema("d", [FieldSchema(
    "emb", DataType.VECTOR, dimension=8,
    index=IndexParams("DISKANN", MetricType.L2,
                      {"ncentroids": 2, "store_dtype": "bfloat16"}))])
eng = Engine(disk, device="cpu", data_dir=tempfile.mkdtemp())
eng.upsert([{"_id": str(i), "emb": [float(i % 5)] * 8} for i in range(64)])
eng.build_index()
eng.indexes["emb"].search(np.ones((1, 8), np.float32), 3, None)
eng.close()
# the storage modes under the runtime layer
from vearch_tpu_torch.engine.engine import SearchRequest
from vearch_tpu_torch.obs import accounting, flight_recorder, quality, sampler
accounting.install()
flight_recorder.install()
for extra in ({"mirror_dtype": "int4"}, {"opq": True, "opq_iters": 1}):
    s2 = TableSchema("o", [FieldSchema(
        "emb", DataType.VECTOR, dimension=8,
        index=IndexParams("IVFPQ", MetricType.L2,
                          dict({"ncentroids": 2, "nsubvector": 2,
                                "train_iters": 2}, **extra)))])
    e2 = Engine(s2, device="cpu")
    e2.upsert([{"_id": str(i), "emb": [float(i % 7), 1.0] * 4}
               for i in range(300)])
    e2.build_index()
    q = np.ones((2, 8), np.float32)
    with accounting.billed("db/s"):
        res = e2.search(SearchRequest(vectors={"emb": q}, k=3, trace={}))
    mon = quality.QualityMonitor(get_engines=lambda: {0: e2},
                                 sample_rate=1.0)
    mon.observe_search(0, "db/s", {"emb": q}, 3, res, e2.data_version)
    mon.run_pending()
    mon.collect_health()
    sampler.DeviceSampler(e2.device_footprint_bytes).sample_now()
    e2.close()
# the cluster plane: master, router and partition servers on the CPU,
# driven through the port's SDK
from vearch_tpu_torch.cluster.standalone import StandaloneCluster
from vearch_tpu_torch.sdk.client import VearchClient
cluster = StandaloneCluster(data_dir=tempfile.mkdtemp(), n_ps=2,
                            ps_kwargs={"device": "cpu",
                                       "heartbeat_interval": 0.3})
cluster.start()
try:
    cl = VearchClient(cluster.router_addr)
    cl.create_database("db")
    cl.create_space("db", {"name": "s", "partition_num": 2,
                           "replica_num": 2, "fields": [
        {"name": "v", "data_type": "vector", "dimension": 8,
         "index": {"index_type": "FLAT", "metric_type": "L2",
                   "params": {}}}]})
    vecs = np.arange(160, dtype=np.float32).reshape(20, 8)
    cl.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i]} for i in range(20)])
    served = cl.search("db", "s", [{"field": "v", "feature": vecs[7]}],
                       limit=1)[0][0]["_id"]
finally:
    cluster.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "vearch_tpu" or m.startswith("vearch_tpu.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
# the native HNSW graph loads the port's own build, never vearch_tpu's
import os
from vearch_tpu_torch.native.hnsw_graph import LIBRARY, HnswGraph
HnswGraph(8).add([[0.0] * 8])
ref_pkg = os.path.join(os.getcwd(), "vearch_tpu") + os.sep
loaded = sorted(getattr(m, "__file__", None) or "" for m in
                list(sys.modules.values()))
print(json.dumps({"modules": names, "bad": bad, "refused": refused,
                  "served": served,
                  "hnsw": LIBRARY.path,
                  "from_ref": [f for f in loaded if f.startswith(ref_pkg)]}))
"""


def test_port_imports_no_jax_and_needs_explicit_cpu():
    # CUDA_VISIBLE_DEVICES="" hides any card, so the default device is
    # absent on every machine this runs on
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for mod in ("vearch_tpu_torch.ops.blockmax_scan",
                "vearch_tpu_torch.ops.probe_dots",
                "vearch_tpu_torch.ops._cuda_build",
                "vearch_tpu_torch.ops.binary_scan",
                "vearch_tpu_torch.ops.scann",
                "vearch_tpu_torch.engine.engine",
                "vearch_tpu_torch.index.ivf", "vearch_tpu_torch.index.binary",
                "vearch_tpu_torch.index.hnsw", "vearch_tpu_torch.index.scann",
                "vearch_tpu_torch.native.hnsw_graph",
                "vearch_tpu_torch.convert",
                "vearch_tpu_torch.engine.batching",
                "vearch_tpu_torch.scalar.manager",
                "vearch_tpu_torch.scalar.indexes",
                "vearch_tpu_torch.engine.disk_vector",
                "vearch_tpu_torch.index.disk",
                "vearch_tpu_torch.index.hbm_cache",
                "vearch_tpu_torch.index._store_paths",
                "vearch_tpu_torch.tiering.prefetch",
                "vearch_tpu_torch.tiering.ram_tier",
                "vearch_tpu_torch.tiering.readahead",
                "vearch_tpu_torch.tiering.staging",
                "vearch_tpu_torch.ops.perf_model",
                "vearch_tpu_torch.index.int8_mirror",
                "vearch_tpu_torch.obs.accounting",
                "vearch_tpu_torch.obs.errors",
                "vearch_tpu_torch.obs.flight_recorder",
                "vearch_tpu_torch.obs.quality",
                "vearch_tpu_torch.obs.quantiles",
                "vearch_tpu_torch.obs.sampler",
                "vearch_tpu_torch.__main__",
                "vearch_tpu_torch.native",
                "vearch_tpu_torch.utils", "vearch_tpu_torch.utils.log",
                "vearch_tpu_torch.tools.lockcheck",
                "vearch_tpu_torch.sdk.client", "vearch_tpu_torch.sdk.objects",
                "vearch_tpu_torch.cluster.admission",
                "vearch_tpu_torch.cluster.auth",
                "vearch_tpu_torch.cluster.config",
                "vearch_tpu_torch.cluster.elastic",
                "vearch_tpu_torch.cluster.entities",
                "vearch_tpu_torch.cluster.grpc_server",
                "vearch_tpu_torch.cluster.hashing",
                "vearch_tpu_torch.cluster.master",
                "vearch_tpu_torch.cluster.metastore",
                "vearch_tpu_torch.cluster.metrics",
                "vearch_tpu_torch.cluster.objectstore",
                "vearch_tpu_torch.cluster.ps",
                "vearch_tpu_torch.cluster.querycache",
                "vearch_tpu_torch.cluster.raft",
                "vearch_tpu_torch.cluster.router",
                "vearch_tpu_torch.cluster.rpc",
                "vearch_tpu_torch.cluster.standalone",
                "vearch_tpu_torch.cluster.tracing",
                "vearch_tpu_torch.cluster.wal"):
        assert mod in got["modules"]
    assert got["refused"] is True
    assert got["served"] == "d7"
    assert got["from_ref"] == []
    assert got["hnsw"].startswith(
        os.path.join(REPO, "vearch_tpu_torch", "_build") + os.sep)
