"""The roofline work of each cell's shapes, worked by hand."""

import pytest

from benchmark.roofline import blockmax_scan, peaks, probe_dots


def test_blockmax_full_scan_batch():
    # sift1m-ivfpq.batch-full: B=1024 queries, 1,000,000 indexed rows of
    # which 990,000 live (1% deleted), d=128
    b, live, indexed, d = 1024, 990_000, 1_000_000, 128
    assert blockmax_scan.ops(b, live, d) == 2 * 1024 * 990_000 * 128
    assert blockmax_scan.ops(b, live, d) == 259_522_560_000
    # queries 262,144 + norms 4,096 + rows 990,000 x 136 = 134,640,000
    # + mask 1,000,000 + maxima 1024 x 1,954 x 4 = 8,003,584
    assert blockmax_scan.nbytes(b, live, indexed, d) == 143_909_824
    # compute-bound: 259.52256e9 / 989e12 s = 0.2624 ms
    t = blockmax_scan.least_seconds(b, live, indexed, d)
    assert t == pytest.approx(259_522_560_000 / 989e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(0.26241, abs=1e-5)


def test_probe_dots_batch():
    # sift1m-ivfpq.batch-probe: B=1024, nprobe 64 of 2048 lists, d=128;
    # say each probed bucket holds 500 live rows and the batch probes
    # 2,000 distinct buckets
    b, d, nprobe, nlist = 1024, 128, 64, 2048
    pairs = 1024 * 64 * 500
    union = 2000 * 500
    assert probe_dots.ops(pairs, d) == 2 * 32_768_000 * 128
    # queries 262,144 + rows 1,000,000 x 128 + pair list 262,144
    # + offsets 8,200 + lengths 8,192 + dots 32,768,000 x 4
    assert probe_dots.nbytes(b, d, nprobe, nlist, pairs, union) == (
        262_144 + 128_000_000 + 262_144 + 8_200 + 8_192 + 131_072_000)
    t = probe_dots.least_seconds(b, d, nprobe, nlist, pairs, union)
    # memory-bound: 259,612,680 B / 3.35e12 B/s = 77.5 us
    assert t == pytest.approx(259_612_680 / 3.35e12, rel=1e-12)
    assert 8.388608e9 / 989e12 < t


def test_probe_dots_online_dispatch():
    # an online dispatch: 10 rows, nprobe 64, every probe a distinct
    # 480-row bucket
    pairs = union = 10 * 64 * 480
    nb = probe_dots.nbytes(10, 128, 64, 2048, pairs, union)
    assert nb == 10 * 256 + 307_200 * 128 + 2_560 + 8_200 + 8_192 \
        + 307_200 * 4
    assert probe_dots.least_seconds(10, 128, 64, 2048, pairs, union) == \
        pytest.approx(nb / 3.35e12, rel=1e-12)


def test_peaks_are_the_data_sheet():
    assert peaks.PEAK_OPS["bf16"] == 989e12
    assert peaks.PEAK_BYTES_PER_S == 3.35e12
    assert peaks.least_seconds(989e12, 0, "bf16") == 1.0
    assert peaks.least_seconds(0, 3.35e12, "bf16") == 1.0
