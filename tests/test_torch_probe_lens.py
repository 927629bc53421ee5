"""The probe-dots kernel's per-bucket live lengths (`lens`) and its
device-side pair grouping, on the CPU.

- The plain `ivf_probe_dots_reference` with `lens` against the reference's
  Pallas `ivf_probe_dots` in interpret mode (the tests/test_pallas.py
  pattern) on chip_smoke.probe_lens_cases() whose buckets are zero past
  their ragged lengths (0, 1, 127, 130 and cap among them): the
  reference has no lengths, and on such buckets none are needed.
  Tolerance: |port - reference| <= 2*d*u*sum|terms| per entry (u =
  2^-24): bf16 x int8 products are exact in f32, so the two differ only
  in the order they sum d exact terms.
- A poisoned tail (random bytes past each length) gives exact zeros
  there, and the live rows match a float64 numpy sum within d*u*sum|terms|.
- `group_pairs` (stable sort of the pairs by probe id, segment offsets,
  the segment of ids < 0 or >= nlist) against a numpy reckoning.
- `_bucket_lens` after a publish of a state converted from the
  reference, against a numpy count of each cell's members in the
  reference's published ids; the probe search gives the same ids with
  and without them.
"""

import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu.ops.pallas_kernels import (  # noqa: E402
    ivf_probe_dots as ref_probe_dots,
)
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine  # noqa: E402
from vearch_tpu_torch.ops import probe_dots as pd  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

U = 2.0 ** -24
CASES = {c[0]: c[1:] for c in chip_smoke.probe_lens_cases()}
# zero tails and every id in range: what the reference kernel can take
ZERO_TAIL = ["ragged", "ragged_d30", "ragged_d100_b1", "all_cells_ragged"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _exact(q, probes, buckets, lens):
    """float64 dots of the bf16-rounded queries over the live rows, and
    the sum of the absolute terms; 0 past each length."""
    qb = np.asarray(q, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)
    vecs = buckets[probes].astype(np.float64)
    live = np.arange(buckets.shape[1])[None, None, :] < lens[probes][..., None]
    dots = np.einsum("bd,bjcd->bjc", qb, vecs)
    mag = np.einsum("bd,bjcd->bjc", np.abs(qb), np.abs(vecs))
    return np.where(live, dots, 0.0), np.where(live, mag, 0.0), live


def _plain(q, probes, buckets, lens):
    return pd.ivf_probe_dots(_t(q).to(torch.bfloat16), _t(probes),
                             _t(buckets), _t(lens)).numpy()


@pytest.mark.parametrize("name", ZERO_TAIL)
def test_plain_with_lens_matches_reference_kernel(name):
    q, probes, buckets, lens = CASES[name]
    assert lens.min() >= 0 and lens.max() <= buckets.shape[1]
    ref = np.asarray(ref_probe_dots(jnp.asarray(q), jnp.asarray(probes),
                                    jnp.asarray(buckets)))
    got = _plain(q, probes, buckets, lens)
    _, mag, _ = _exact(q, probes, buckets, lens)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= 2 * q.shape[1] * U * mag).all()


@pytest.mark.parametrize("name", ["poisoned", "one_bucket_b70"])
def test_rows_past_lens_give_zeros(name):
    q, probes, buckets, lens = CASES[name]
    got = _plain(q, probes, buckets, lens)
    want, mag, live = _exact(q, probes, buckets, lens)
    assert (got[~live] == 0).all()
    assert (np.abs(got - want) <= q.shape[1] * U * mag).all()
    if name == "poisoned":  # the tails are not zero: lens did the work
        tail = np.arange(buckets.shape[1])[None, :] >= lens[:, None]
        assert np.abs(buckets[tail]).sum() > 0


def _np_group(probes, nlist):
    flat = probes.reshape(-1).astype(np.int64)
    key = np.where((flat >= 0) & (flat < nlist), flat, nlist)
    order = np.argsort(key, kind="stable")
    offs = np.searchsorted(key[order], np.arange(nlist + 2), side="left")
    return order, offs


@pytest.mark.parametrize("seed,b,nprobe,nlist", [
    (61, 1, 1, 1), (62, 7, 5, 16), (63, 64, 16, 9), (64, 300, 8, 2048)])
def test_group_pairs_matches_numpy(seed, b, nprobe, nlist):
    rng = np.random.default_rng(seed)
    probes = rng.integers(-2, nlist + 2, (b, nprobe)).astype(np.int32)
    probes[0, 0] = 2 ** 31 - 1
    order, offs = pd.group_pairs(_t(probes), nlist)
    assert order.dtype == offs.dtype == torch.int32
    want_order, want_offs = _np_group(probes, nlist)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offs.numpy(), want_offs)
    # every pair once; segment c holds exactly the pairs that probe c
    flat = probes.reshape(-1)
    for c in range(nlist + 1):
        seg = order.numpy()[offs[c]:offs[c + 1]]
        if c < nlist:
            assert (flat[seg] == c).all()
            assert seg.size == int((flat == c).sum())
        else:
            assert ((flat[seg] < 0) | (flat[seg] >= nlist)).all()


D, N = 32, 2048
PARAMS = {"ncentroids": 16, "nsubvector": 8, "train_iters": 4,
          "training_threshold": 10 ** 9, "scan_mode": "probe", "nprobe": 5,
          "mesh_serving": "off"}


def _schema(t):
    return t.TableSchema("t", [t.FieldSchema(
        "emb", t.DataType.VECTOR, dimension=D,
        index=t.IndexParams("IVFPQ", t.MetricType.L2, dict(PARAMS)))])


def test_bucket_lens_count_each_cells_members():
    rng = np.random.default_rng(71)
    centers = rng.standard_normal((12, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 12, N)]
            + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    docs = [{"_id": f"d{i}", "emb": vecs[i]} for i in range(N)]
    ref = RefEngine(_schema(rt))
    ref.micro_batch = False
    port = Engine(_schema(pt), device="cpu")
    ref.upsert(docs)
    port.upsert(docs)
    ref.build_index()
    ri, pi = ref.indexes["emb"], port.indexes["emb"]
    queries = vecs[:6] + 0.01
    ref.search(RefRequest(vectors={"emb": queries}, k=10))  # publishes
    pi.load_state(index_state_from_reference(ri.dump_state()))
    pi._publish()
    # the reference packs each cell's members at the front of its bucket
    counts = (np.asarray(ri._bucket_ids) >= 0).sum(axis=1).astype(np.int32)
    assert counts.sum() == N and counts.max() > counts.min()
    np.testing.assert_array_equal(pi._bucket_lens.numpy(), counts)
    np.testing.assert_array_equal(
        [len(mm) for mm in pi._members], counts)
    assert (pi._bucket_ids.numpy()[np.arange(pi._cap)[None, :]
                                   >= counts[:, None]] == -1).all()
    # the search's answers do not change with the lengths
    args = (torch.from_numpy(queries), pi.centroids, pi._bucket_resid8,
            pi._bucket_scale, pi._bucket_vsq, pi._bucket_ids,
            torch.ones(N, dtype=torch.bool), 5, 40)
    s_all, i_all = pd.ivfpq_probe_search(*args)
    s_len, i_len = pd.ivfpq_probe_search(*args, bucket_lens=pi._bucket_lens)
    assert torch.equal(i_all, i_len)
    assert torch.equal(s_all, s_len)
