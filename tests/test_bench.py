"""Benchmark harness tests (tiny scales)."""

import numpy as np

from adacom.bench import runner
from adacom.bench import succinct_benchmarks  # noqa: F401 (registers)
from adacom.bench.zipf import ZipfSampler


def test_zipf_sampler_bounds_and_skew():
    z = ZipfSampler(10_000, 1.0, seed=1)
    s = z.sample(20_000)
    assert s.min() >= 1 and s.max() <= 10_000
    # k=1 skew: rank-1 frequency dominates
    vals, counts = np.unique(s, return_counts=True)
    top = vals[np.argmax(counts)]
    assert top <= 3
    # higher skew concentrates more mass on rank 1
    s2 = ZipfSampler(10_000, 2.0, seed=1).sample(20_000)
    assert (s2 == 1).mean() > (s == 1).mean()


def test_runner_zipf_distribution_small():
    cls = runner.REGISTRY["SuccinctZipfDistribution"]
    recs = runner.run_benchmark(cls, scale=0.001, nruns=1)
    assert len(recs) == 1
    assert recs[0]["MemoryAllocationInBytes"] > 0
    # succinct footprint beats the 4B/row plain encoding
    n_rows = max(1024, int(100e6 * 0.001))
    assert recs[0]["MemoryAllocationInBytes"] < n_rows * 4


def test_runner_compression_vs_plain():
    got = {}
    for name in ("SuccinctZipfScanOOM", "NonSuccinctZipfScanOOM"):
        recs = runner.run_benchmark(runner.REGISTRY[name], scale=0.001, nruns=1)
        got[name] = recs[0]["MemoryAllocationInBytes"]
    assert got["SuccinctZipfScanOOM"] <= got["NonSuccinctZipfScanOOM"] * 0.6
