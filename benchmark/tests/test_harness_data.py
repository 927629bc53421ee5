"""The data recipe is the same for one seed and differs between seeds."""

import numpy as np
import pytest

from benchmark.harness import spec

PARAMS = {"recipe": "gaussian_clusters", "rows": 4000, "dim": 16,
          "rows_seed": 0,
          "clusters": 40, "center_scale": 3.0, "row_noise": 0.7,
          "query_noise": 0.1, "query_pool": 256, "delete_share": 0.01}


def make(seed, **over):
    mod = spec.load_module("data", "gaussian_clusters")
    return mod.make(dict(PARAMS, **over), seed, "cpu")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -3])
def test_one_seed_gives_the_same_data(seed):
    a, b = make(seed), make(seed)
    assert np.array_equal(a.rows, b.rows)
    assert np.array_equal(a.queries, b.queries)
    assert np.array_equal(a.deleted, b.deleted)


def test_seeds_draw_queries_and_deletes_over_one_set_of_rows():
    a, b = make(1), make(2)
    assert np.array_equal(a.rows, b.rows)
    assert not np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.deleted, b.deleted)
    c = make(1, rows_seed=5)
    assert not np.array_equal(a.rows, c.rows)
    assert np.array_equal(a.deleted, c.deleted)


def test_shapes_and_deletes():
    d = make(3)
    assert d.rows.shape == (4000, 16) and d.rows.dtype == np.float32
    assert d.queries.shape == (256, 16)
    assert len(d.deleted) == 40 and len(set(d.deleted.tolist())) == 40
    assert np.all(np.diff(d.deleted) > 0)
    assert d.alive().sum() == 4000 - 40
    # each query lies near a distinct base row (query_noise 0.1)
    near = ((d.queries[:, None, :] - d.rows[None, :, :]) ** 2).sum(-1)
    src = near.argmin(1)
    assert len(set(src.tolist())) == 256
    assert np.sqrt(near.min(1)).max() < 1.0
