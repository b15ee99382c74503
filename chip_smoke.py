#!/usr/bin/env python
"""Bring-up check: the engine's main path on one NVIDIA GPU.

    python chip_smoke.py              # one card
    python chip_smoke.py --chips 4    # only the mesh tier, on four cards

One card: the GPU-marked tests (tests/test_gpu.py), then SuccinctZipf at
100M rows (load, compact, Zipf point lookups on the host latency tier and
the full compressed scan on the device tier, checked against closed forms
and NumPy), then TPC-H SF1 (Q1, Q6 and a small-domain GROUP BY on the
device tier, checked against sqlite3). Every device-tier query must raise
the executor's device_scan_agg_gpu counter. With --chips 4 only the mesh
tier runs: the SF1 scan-aggregates and a lineitem-orders shuffle join on a
four-card mesh, compared with one card and with sqlite3.

Integers must match exactly. Floats are compared at rel_tol=1e-9: the
GPU's reductions sum in another order than sqlite3 does.

The last line of output is {"ok": true, "device": {...}}; any failed check
raises, and the script exits non-zero without that line. It refuses to run
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sqlite3
import subprocess
import sys
import time

import numpy as np

ZIPF_ROWS = 100_000_000
ZIPF_LOOKUPS = 1_000
TPCH_SF = 1.0
REL_TOL = 1e-9

GROUP_BY_SQL = ("SELECT l_linenumber, count(*), sum(l_quantity), "
                "sum(l_extendedprice) FROM lineitem GROUP BY l_linenumber "
                "ORDER BY l_linenumber")
JOIN_SQL = ("SELECT count(*), sum(l_quantity), sum(o_totalprice) "
            "FROM lineitem, orders WHERE l_orderkey = o_orderkey "
            "AND o_orderdate < '1995-03-15'")
# lineitem/orders columns the oracle queries read
ORACLE_COLS = {
    "lineitem": ["l_orderkey", "l_linenumber", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                 "l_linestatus", "l_shipdate"],
    "orders": ["o_orderkey", "o_totalprice", "o_orderdate"],
}


class SmokeLog:
    """Per-phase wall times, printed with the card they ran on."""

    def __init__(self, card: str):
        self.card = card

    def timed(self, label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        print(f"  {label}: {dt:.6f} s [{self.card}]", flush=True)
        return out


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rows_match(got, exp) -> bool:
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, (float, np.floating)) or \
                    isinstance(b, (float, np.floating)):
                if a is None or b is None or not math.isclose(
                        float(a), float(b), rel_tol=REL_TOL):
                    return False
            elif (None if a is None else str(a)) != \
                    (None if b is None else str(b)):
                return False
    return True


def _norm(rows):
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in r)
            for r in rows]


def check_rows(label, got, exp):
    got, exp = _norm(got), _norm(exp)
    if not rows_match(got, exp):
        raise AssertionError(f"{label}: engine {got[:4]} != oracle {exp[:4]}")


def device_query(db, con, sql, platform):
    """Run sql; assert the device scan-aggregate tier ran on `platform`."""
    key = f"device_scan_agg_{platform}"
    before = db.dist_stats.get(key, 0)
    rows = con.query(sql).fetchall()
    if db.dist_stats.get(key, 0) <= before:
        raise AssertionError(f"device tier did not run on {platform}: {sql}")
    return rows


def scan_step_memory(db, table_name):
    """compiled.memory_analysis() of the pooled scan-aggregate step of the
    one unfiltered aggregate query run so far over `table_name`."""
    table = db.catalog.get_table(table_name)
    stacks = {k[3]: v for k, v in table._pool_cache.items()
              if isinstance(k, tuple) and len(k) == 5}
    seen, todo = set(), list(db.plan_cache.values())
    while todo:
        node = todo.pop()
        if id(node) in seen or not hasattr(node, "__dict__"):
            continue
        seen.add(id(node))
        for key, kern in getattr(node, "_agg_kernels", {}).items():
            if key[0] == "pool" and key[2] in stacks:
                arrays, counts = stacks[key[2]]
                return kern.lower(counts, (), (), *arrays).compile() \
                    .memory_analysis()
        for v in vars(node).values():
            todo.extend(v if isinstance(v, list) else [v])
    raise AssertionError(f"no pooled scan step found for {table_name}")


def phase_zipf(rows, n_lookups, platform, log):
    """SuccinctZipf: lookups on the host tier, full scan on the device."""
    from adacom.bench.succinct_benchmarks import SuccinctZipfDistribution

    bench = SuccinctZipfDistribution(rows / 100e6)
    bench.n_lookups = n_lookups
    state = {}
    log.timed("zipf load+compact", bench.load, state)
    db, con, n = state["db"], state["con"], state["n"]
    assert n == rows, (n, rows)
    keys = np.asarray(state["data"], np.int64)

    def lookups():
        return [con.query(f"SELECT i FROM t1 WHERE i == {int(v)}").fetchall()
                for v in keys]

    got = log.timed(f"zipf {len(keys)} point lookups", lookups)
    table = np.arange(n, dtype=np.int64)   # what the benchmark ingests
    pos = np.minimum(np.searchsorted(table, keys), n - 1)
    for v, hit, r in zip(keys, table[pos] == keys, got):
        exp = [(int(v),)] if hit else []
        if [tuple(int(x) for x in row) for row in r] != exp:
            raise AssertionError(f"lookup {v}: {r} != {exp}")

    scan = "SELECT count(*), sum(i) FROM t1"
    r = log.timed("zipf full scan (cold)", device_query, db, con, scan,
                  platform)
    check_rows(scan, r, [(n, n * (n - 1) // 2)])
    for k in range(3):
        log.timed(f"zipf full scan (hot {k})", device_query, db, con, scan,
                  platform)
    print(f"  zipf scan step memory: {scan_step_memory(db, 't1')}",
          flush=True)
    lo, hi = n // 3, (2 * n) // 3
    ranged = f"SELECT count(*), sum(i) FROM t1 WHERE i >= {lo} AND i < {hi}"
    r = log.timed("zipf range scan", device_query, db, con, ranged, platform)
    check_rows(ranged, r, [(hi - lo, (hi - lo) * (lo + hi - 1) // 2)])
    bench.cleanup(state)
    db.close()


def load_tpch(sf, log, mesh=None):
    import adacom as at
    from adacom.bench import tpch

    data = log.timed(f"tpch sf={sf} generate", tpch.generate, sf)
    if mesh is not None:
        data = {t: data[t] for t in ORACLE_COLS}
    db = at.Database(mesh=mesh)
    con = db.connect()
    log.timed("tpch load", tpch.load_into_engine, con, data)
    log.timed("tpch compact",
              db.catalog.get_column_segment_catalog().compact_all_segments)
    lite = sqlite3.connect(":memory:")
    subset = {t: {c: data[t][c] for c in cols}
              for t, cols in ORACLE_COLS.items()}
    log.timed("sqlite load", tpch.load_into_sqlite, lite, subset)
    return data, db, con, lite


def phase_tpch(sf, platform, log):
    """TPC-H Q1, Q6 and a small-domain GROUP BY against sqlite3."""
    from adacom.bench import tpch

    _data, db, con, lite = load_tpch(sf, log)
    queries = [("Q1", tpch.QUERIES[1], tpch.oracle_sql(1)),
               ("Q6", tpch.QUERIES[6], tpch.oracle_sql(6)),
               ("group by l_linenumber", GROUP_BY_SQL, GROUP_BY_SQL)]
    for label, sql, oracle in queries:
        got = log.timed(f"tpch {label} (cold)", device_query, db, con, sql,
                        platform)
        log.timed(f"tpch {label} (hot)", device_query, db, con, sql,
                  platform)
        check_rows(label, got, lite.execute(oracle).fetchall())
    print(f"  tpch counters: {db.dist_stats}", flush=True)
    db.close()


def phase_mesh(n_dev, sf, platform, log):
    """Mesh tier: sharded scan-aggregates and the shuffle join, compared
    with a one-device database and sqlite3."""
    import adacom as at
    from adacom.bench import tpch
    from adacom.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_dev)
    data, db, con, lite = load_tpch(sf, log, mesh=mesh)
    one = at.Database()
    one_con = one.connect()
    tpch.load_into_engine(one_con, data)
    one.catalog.get_column_segment_catalog().compact_all_segments()
    for label, sql, oracle, stat in [
            ("Q1", tpch.QUERIES[1], tpch.oracle_sql(1), "scan_agg"),
            ("Q6", tpch.QUERIES[6], tpch.oracle_sql(6), "scan_agg"),
            ("lineitem x orders", JOIN_SQL, JOIN_SQL, "join")]:
        before = db.dist_stats[stat]
        got = log.timed(f"mesh {label} (cold)",
                        lambda: con.query(sql).fetchall())
        log.timed(f"mesh {label} (hot)", lambda: con.query(sql).fetchall())
        if db.dist_stats[stat] <= before:
            raise AssertionError(f"mesh {stat} did not run for {label}")
        check_rows(f"{label} vs one device", got,
                   one_con.query(sql).fetchall())
        check_rows(f"{label} vs sqlite", got, lite.execute(oracle).fetchall())
    pooled = [a for k, v in db.catalog.get_table("lineitem")._pool_cache
              .items() if isinstance(k, tuple) and len(k) == 5
              for a in v[0]]
    spread = {d.platform + str(d.id) for a in pooled
              for d in a.sharding.device_set}
    print(f"  mesh segment pools on devices: {sorted(spread)}", flush=True)
    if not pooled or len(spread) != n_dev or any(
            len(a.sharding.device_set) != n_dev for a in pooled):
        raise AssertionError(f"segment pools not spread over {n_dev} "
                             f"devices: {sorted(spread)}")
    if any(d.platform != platform for a in pooled
           for d in a.sharding.device_set):
        raise AssertionError(f"segment pools not on {platform}")
    one.close()
    db.close()


def phase_gpu_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"GPU tests failed (pytest exit {rc})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    import adacom
    from adacom import native

    card = card_line()
    print(f"device_kind: {dev.device_kind}")
    print(f"device count: {len(devices)}")
    print(f"nvidia-smi: {card}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"native host runtime live: {native.available()}")
    print(f"adacom from: {os.path.dirname(adacom.__file__)}", flush=True)
    if not native.available():
        raise AssertionError("native host runtime did not build or load")
    log = SmokeLog(card)
    t0 = time.perf_counter()
    if args.chips == 4:
        log.timed("phase mesh x4", phase_mesh, 4, TPCH_SF, "gpu", log)
    else:
        log.timed("phase gpu tests", phase_gpu_tests)
        log.timed("phase zipf", phase_zipf, ZIPF_ROWS, ZIPF_LOOKUPS, "gpu",
                  log)
        log.timed("phase tpch", phase_tpch, TPCH_SF, "gpu", log)
    print(f"total: {time.perf_counter() - t0:.3f} s [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
