"""Tests that need an NVIDIA GPU: each takes the `gpu` fixture, which skips
where JAX has no GPU. chip_smoke.py runs them on the card."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import adacom as at

pytestmark = pytest.mark.gpu


def _db(n=300_000):
    cfg = at.DBConfig()
    cfg.segment_rows = 1 << 14
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(g INTEGER, i UINTEGER)")
    app = con.appender("t")
    app.append_columns({"g": (np.arange(n) % 5).astype(np.int32),
                        "i": np.arange(n, dtype=np.uint32)})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con, n


def test_device_tier_runs_on_gpu(gpu):
    db, con, n = _db()
    r = con.query("SELECT count(*), sum(i) FROM t").fetchone()
    assert (int(r[0]), int(r[1])) == (n, n * (n - 1) // 2)
    r = con.query("SELECT g, count(*) FROM t GROUP BY g ORDER BY g"
                  ).fetchall()
    assert [(int(a), int(b)) for a, b in r] == [(g, n // 5) for g in range(5)]
    assert db.dist_stats["device_scan_agg_gpu"] >= 2
    assert db.dist_stats["device_scan_agg"] == \
        db.dist_stats["device_scan_agg_gpu"]
    db.close()


def test_device_profile_trace_has_gpu_plane(gpu, tmp_path):
    db, con, _n = _db()
    d = str(tmp_path / "trace")
    con.query(f"PRAGMA device_profile_start('{d}')")
    con.query("SELECT sum(i) FROM t WHERE i < 1000000").fetchall()
    assert con.query("PRAGMA device_profile_stop").fetchall() == [(d,)]
    (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)
    planes = [p.name for p in jax.profiler.ProfileData.from_file(path).planes]
    assert any(p.startswith("/device:GPU") for p in planes), planes
    db.close()


def test_fused_multi_kernel_builds_at_bench_shape(gpu):
    """Compile the Triton multi-aggregate kernel at the 100M-row shape
    (1526 segments of 2048 lanes, 16-bit value plane)."""
    from adacom.ops import gpu_scan

    n_seg, lanes = 1526, 2048
    run = gpu_scan._build(n_seg, lanes, (3,), (16,), 7, (1,), ((0,),),
                          (0,), False)
    shapes = (jax.ShapeDtypeStruct((n_seg, 32), jnp.int64),
              jax.ShapeDtypeStruct((n_seg, 3, lanes), jnp.uint32),
              jax.ShapeDtypeStruct((n_seg, 16, lanes), jnp.uint32))
    run.lower(*shapes).compile()
