#!/usr/bin/env python
"""Fused compressed-scan kernels on the card: XLA vs the Pallas (Triton)
kernel, at kernel level and end to end.

Kernel level (device arrays, timed to block_until_ready, the two versions
alternating X T T X): three shapes over bit-packed planes (ops/bitpack.py
layout, 65536-row segments) at each value width --
  scan:    count/sum of one plane under a range predicate;
  grouped: per-group count/sum of one plane over a 7-value group plane;
  multi:   TPC-H Q1's shape -- 2 group planes, 5 value planes, monomials of
           degree 1-3, a range predicate on one plane.
The XLA version is the engine's plain path (bitpack.unpack per segment,
vmapped, masked one-hot sums); the kernel is ops/gpu_scan.multi_scan.
Results must agree exactly. Rates are packed bytes read over kernel time,
also as a share of the card's published HBM bandwidth.

End to end (--e2e): SuccinctZipf's full scan at 100M rows and TPC-H SF1
Q1, Q6 and a GROUP BY l_linenumber, through Database.connect().query(),
with DBConfig.fused_scan_kernel "off" (XLA) and "gpu" (the kernel where
the executor routes the shape to it), alternating.

Usage: python tools/roofline.py [--rows 100e6] [--widths 8,16,24,32]
                                [--runs 10] [--e2e] [--sf 1.0]
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published peak HBM bandwidth by jax device_kind, GB/s.
# NVIDIA H100 Tensor Core GPU datasheet: H100 SXM5 80 GB, 3.35 TB/s.
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

SEG_ROWS = 1 << 16
LANES = SEG_ROWS // 32


def device_info():
    import jax

    dev = jax.devices()[0]
    if dev.device_kind not in HBM_GBPS:
        raise SystemExit(f"no published HBM bandwidth for {dev.device_kind!r}"
                         f"; add it to HBM_GBPS with its source")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return dev, HBM_GBPS[dev.device_kind], card


def make_planes(key, n_seg, widths, spans):
    """Packed (n_seg, w, LANES) planes of random codes in [0, span]."""
    import jax
    import jax.numpy as jnp
    from adacom.ops import bitpack

    planes = []
    for i, (w, span) in enumerate(zip(widths, spans)):
        k = jax.random.fold_in(key, i)
        codes = jax.random.randint(k, (n_seg, 32, LANES), 0, span + 1,
                                   dtype=jnp.int64).astype(jnp.uint32)
        planes.append(jax.jit(jax.vmap(
            lambda r, w=w: bitpack.pack(r, width=w)))(codes))
    return planes


def xla_multi(n_groups, gws, vws, strides, monos, preds):
    """The engine's plain XLA path for the same computation."""
    import jax
    import jax.numpy as jnp
    from adacom.ops import agg, bitpack
    from adacom.ops import gpu_scan as gs

    n_g = len(gws)

    def seg(scal, *planes):
        n_pad = 32 * LANES
        codes = [bitpack.unpack(p, width=w).reshape(-1)
                 for p, w in zip(planes, gws + vws)]
        mask = jnp.arange(n_pad) < scal[gs.SC_COUNT]
        vals = [c.astype(jnp.int64) + scal[gs.SC_VMIN + p]
                for p, c in enumerate(codes[n_g:])]
        for q, p in enumerate(preds):
            mask = mask & (vals[p] >= scal[gs.SC_LO + q]) \
                & (vals[p] <= scal[gs.SC_HI + q])
        gid = jnp.zeros(n_pad, jnp.int32)
        for j in range(n_g):
            gid = gid + (codes[j].astype(jnp.int32)
                         + scal[gs.SC_GMIN + j].astype(jnp.int32)) \
                * strides[j]
        specs = []
        for m in monos:
            term = vals[m[0]]
            for p in m[1:]:
                term = term * vals[p]
            specs.append(("sum", term, jnp.int64))
        specs.append(("count", None, jnp.int64))
        return jnp.stack(agg.grouped_partial(gid, mask, specs, n_groups),
                         axis=1)

    @jax.jit
    def run(scal, *planes):
        return jax.vmap(seg)(scal, *planes).sum(axis=0)

    return run


def time_pair(fa, fb, args, runs):
    """Median seconds of fa and fb, alternating a b b a."""
    ta, tb = [], []

    def one(f, acc):
        t0 = time.perf_counter()
        f(*args).block_until_ready()
        acc.append(time.perf_counter() - t0)

    for _ in range(runs):
        one(fa, ta)
        one(fb, tb)
        one(fb, tb)
        one(fa, ta)
    return statistics.median(ta), statistics.median(tb)


SHAPES = {
    # name: (n_groups, group planes as (width, max code), value planes,
    #        strides, monos, preds)
    "scan": (1, [], 1, (), ((0,),), (0,)),
    "grouped": (7, [(3, 6)], 1, (1,), ((0,),), ()),
    "multi": (6, [(2, 2), (1, 1)], 5, (2, 1),
              ((0,), (1,), (1, 2), (1, 2, 3), (2,)), (4,)),
}


def kernel_level(rows, widths, runs, peak, card):
    import jax
    import jax.numpy as jnp
    from adacom.ops import gpu_scan

    n_seg = int(rows) // SEG_ROWS
    print(f"kernel level: {n_seg} segments x {SEG_ROWS} rows = "
          f"{n_seg * SEG_ROWS:,} rows", flush=True)
    key = jax.random.PRNGKey(0)
    for name, (G, groups, n_v, strides, monos, preds) in SHAPES.items():
        for w in widths:
            gws = tuple(g[0] for g in groups)
            vws = (w,) * n_v
            span = (1 << w) - 1
            planes = make_planes(key, n_seg, gws + vws,
                                 [g[1] for g in groups] + [span] * n_v)
            scal = np.zeros((n_seg, 32), np.int64)
            scal[:, gpu_scan.SC_COUNT] = SEG_ROWS
            scal[:, gpu_scan.SC_LANES] = LANES
            scal[:, gpu_scan.SC_VMIN:gpu_scan.SC_VMIN + n_v] = 7
            for q, _p in enumerate(preds):
                scal[:, gpu_scan.SC_LO + q] = 7 + span // 4
                scal[:, gpu_scan.SC_HI + q] = 7 + (3 * span) // 4
            args = (jnp.asarray(scal), *planes)
            fx = xla_multi(G, gws, vws, strides, monos, preds)
            fk = gpu_scan._build(n_seg, LANES, gws, vws, G, strides, monos,
                                 preds, False)
            t0 = time.perf_counter()
            rx = np.asarray(fx(*args))
            cx = time.perf_counter() - t0
            t0 = time.perf_counter()
            rk = np.asarray(fk(*args))
            ck = time.perf_counter() - t0
            if not np.array_equal(rx, rk):
                raise AssertionError(f"{name} w={w}: xla {rx} != kernel {rk}")
            tx, tk = time_pair(fx, fk, args, runs)
            nbytes = sum(int(p.size) * 4 for p in planes)
            for label, t, c in (("xla", tx, cx), ("kernel", tk, ck)):
                gbps = nbytes / t / 1e9
                print(f"  {name:8s} w={w:2d} {label:6s} {t * 1e3:9.4f} ms "
                      f"{gbps:8.1f} GB/s {100 * gbps / peak:5.1f}% of "
                      f"{peak:.0f} GB/s  (first call {c:.2f} s) [{card}]",
                      flush=True)
            del planes, args


def end_to_end(rows, sf, runs, card):
    import chip_smoke
    from adacom.bench import tpch
    from adacom.bench.succinct_benchmarks import SuccinctZipfDistribution

    log = chip_smoke.SmokeLog(card)
    bench = SuccinctZipfDistribution(rows / 100e6)
    bench.n_lookups = 1
    state = {}
    log.timed("zipf load+compact", bench.load, state)
    cases = [(state["db"], state["con"], "zipf scan",
              "SELECT count(*), sum(i) FROM t1")]
    _data, db, con, _lite = chip_smoke.load_tpch(sf, log)
    cases += [(db, con, "Q1", tpch.QUERIES[1]),
              (db, con, "Q6", tpch.QUERIES[6]),
              (db, con, "group by", chip_smoke.GROUP_BY_SQL)]
    for d, c, label, sql in cases:
        def mode(on, d=d, c=c, sql=sql):
            d.config.fused_scan_kernel = "gpu" if on else "off"
            t0 = time.perf_counter()
            rows_ = c.query(sql).fetchall()
            return rows_, time.perf_counter() - t0
        rx, cold_x = mode(False)
        before = d.dist_stats.get("fused_multi_agg", 0)
        rk, cold_k = mode(True)
        routed = d.dist_stats.get("fused_multi_agg", 0) > before
        chip_smoke.check_rows(f"{label} kernel vs xla", rk, rx)
        tx, tk = [], []
        for _ in range(runs):
            tx.append(mode(False)[1])
            tk.append(mode(True)[1])
            tk.append(mode(True)[1])
            tx.append(mode(False)[1])
        print(f"  e2e {label:9s} off {statistics.median(tx) * 1e3:9.3f} ms "
              f"gpu {statistics.median(tk) * 1e3:9.3f} ms  kernel "
              f"{'ran' if routed else 'not routed'} (cold off {cold_x:.2f} s,"
              f" gpu {cold_k:.2f} s) [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=float, default=100e6)
    ap.add_argument("--widths", default="8,16,24,32")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    import adacom.types  # noqa: F401  (x64, as the engine runs)

    dev, peak, card = device_info()
    print(f"device: {dev.device_kind}  peak HBM {peak:.0f} GB/s  "
          f"nvidia-smi: {card}", flush=True)
    kernel_level(args.rows, [int(w) for w in args.widths.split(",")],
                 args.runs, peak, card)
    if args.e2e:
        end_to_end(args.rows, args.sf, args.runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
