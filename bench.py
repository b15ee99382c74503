#!/usr/bin/env python
"""Headline benchmark: SuccinctZipfDistribution (reference
benchmark/micro/succinct/zipf_distribution.cpp — 100M-row sequential
UINTEGER table, compacted to the succinct representation, 10k Zipf(k=1)
point lookups; methodology = 1 discarded cold run + 5 hot runs, mean).

Reference baseline: 17.49 s per hot run on the authors' server
(/root/reference/benchmarks.csv:32-36; BASELINE.md). Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline"} where vs_baseline = ours/theirs
(< 1.0 is faster than the reference).

What each number measures:
- the headline point-lookup timing exercises the HOST LATENCY TIER
  (zonemap pruning + native SIMD eq-scan of the one candidate segment) —
  point lookups touching <=4 segments never pay a device round trip;
- "device_scan" exercises the DEVICE TIER: the fused XLA bit-unpack +
  aggregate kernel streaming the whole compressed table from device
  memory (SELECT count(*), sum(i) FROM t1), the reference's ScanOOM-style
  workload (~4.1 s/100 scans there, benchmarks.csv:57-61);
- "memory" is the reference's core claim: succinct vs plain footprint of
  the same data (reference shows 17-50% reduction, BASELINE.md).

Scale with ADACOM_BENCH_SCALE (default 1.0 = the full 100M rows). The
JSON names the device, and on a GPU the card's name and power limit."""

import json
import os
import subprocess
import sys
import time


def device_label():
    """JAX's device, plus nvidia-smi's name and power limit on a GPU."""
    import jax

    dev = jax.devices()[0]
    label = f"{dev.platform} ({dev.device_kind}) x{len(jax.devices())}"
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
        label += f"; {card}"
    return label


def main():
    scale = float(os.environ.get("ADACOM_BENCH_SCALE", "1.0"))
    nruns = int(os.environ.get("ADACOM_BENCH_RUNS", "5"))
    t_start = time.time()

    def mark(phase):
        print(f"[bench +{time.time() - t_start:7.1f}s] {phase}",
              file=sys.stderr, flush=True)

    from adacom.bench.runner import run_benchmark
    from adacom.bench.succinct_benchmarks import SuccinctZipfDistribution

    # ---- headline: Zipf point lookups over the compacted table ----
    mark("load start")
    b = SuccinctZipfDistribution(scale)
    state = {}
    b.load(state)
    mark("load done")
    db = state["db"]
    cat = db.catalog.get_column_segment_catalog()
    succinct_bytes = cat.get_total_data_size()
    records = []
    for run in range(nruns + 1):
        t0 = time.perf_counter()
        b.run(state)
        timing = time.perf_counter() - t0
        err = b.verify(state)
        if err:
            raise AssertionError(f"verification failed: {err}")
        if run == 0:
            continue  # discarded cold run
        records.append(timing)
        print(f"SuccinctZipfDistribution\t{run}\t{timing:.6f}\t"
              f"{succinct_bytes}\t{cat.get_total_data_size()}",
              file=sys.stderr, flush=True)
    mark("lookup runs done")
    mean_s = sum(records) / len(records)
    baseline_s = 17.49  # benchmarks.csv:32-36 mean, 5 hot runs

    # ---- device tier: fused full-table compressed scan ----
    con = state["con"]
    n = state["n"]
    scan_sql = "SELECT count(*), sum(i) FROM t1"
    res = con.query(scan_sql).fetchone()
    assert int(res[0]) == n and int(res[1]) == n * (n - 1) // 2, res
    n_scan = 20
    t0 = time.perf_counter()
    for _ in range(n_scan):
        con.query(scan_sql)
    scan_s = (time.perf_counter() - t0) / n_scan
    mark("device scans done")
    # reference SuccinctScanOOM: 100 such scans over 150M rows in ~4.10 s
    # (benchmarks.csv:57-61) -> per-scan time scaled to our row count
    ref_scan_s = 4.10 / 100 * (n / 150e6)
    device_scan = {
        "query": scan_sql,
        "time_s": round(scan_s, 5),
        "packed_gbps": round(succinct_bytes / scan_s / 1e9, 1),
        "grows_per_s": round(n / scan_s / 1e9, 2),
        "vs_reference_scan": round(scan_s / ref_scan_s, 4),
    }
    b.cleanup(state)
    mark("cleanup done")

    # ---- memory story: plain (non-succinct) footprint of the same data ----
    from adacom.bench.succinct_benchmarks import NonSuccinctZipfDistribution

    b2 = NonSuccinctZipfDistribution(scale)
    state2 = {}
    b2.load(state2)
    plain_bytes = state2["db"].catalog.get_column_segment_catalog() \
        .get_total_data_size()
    b2.cleanup(state2)
    mark("non-succinct load done")

    out = {
        "metric": "SuccinctZipfDistribution (10k Zipf point lookups, "
                  f"{int(100e6 * scale)} rows)",
        "value": round(mean_s, 4),
        "unit": "s",
        "vs_baseline": round(mean_s / baseline_s, 4),
        "detail": {
            "tier": "host latency tier (zonemap + native eq-scan); "
                    "device_scan below is the device tier",
            "device": device_label(),
            "hot_runs_s": [round(r, 4) for r in records],
            "device_scan": device_scan,
            "memory": {
                "succinct_bytes": succinct_bytes,
                "non_succinct_bytes": plain_bytes,
                "reduction": round(1 - succinct_bytes / plain_bytes, 4)
                if plain_bytes else None,
            },
            "scale": scale,
            "wall_total_s": round(time.time() - t_start, 1),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
