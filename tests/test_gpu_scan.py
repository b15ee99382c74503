"""The Pallas (Triton) multi-aggregate scan kernel (ops/gpu_scan.py) in
interpret mode against NumPy, and the executor's choice of it
(DBConfig.fused_scan_kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest

import adacom as at
from adacom.ops import bitpack, gpu_scan

SEG_ROWS = 8192
LANES = SEG_ROWS // 32


def _planes(cols, widths, counts):
    """Packed (n_seg, w, LANES) stacks; a ragged segment's lanes are
    zero-padded. Zero-width planes are None."""
    out = []
    for col, w in zip(cols, widths):
        if w == 0:
            out.append(None)
            continue
        segs = []
        for s, n in enumerate(counts):
            words = bitpack.pack_numpy(col[s, :n], w)
            segs.append(np.pad(words, ((0, 0), (0, LANES - words.shape[1]))))
        out.append(jnp.asarray(np.stack(segs)))
    return out


def _scal(counts, gmins=(), vmins=(), ranges=()):
    scal = np.zeros((len(counts), 32), np.int64)
    scal[:, gpu_scan.SC_COUNT] = counts
    scal[:, gpu_scan.SC_LANES] = [bitpack.lanes_for(n) for n in counts]
    for j, g in enumerate(gmins):
        scal[:, gpu_scan.SC_GMIN + j] = g
    for p, v in enumerate(vmins):
        scal[:, gpu_scan.SC_VMIN + p] = v
    for q, (lo, hi) in enumerate(ranges):
        scal[:, gpu_scan.SC_LO + q] = lo
        scal[:, gpu_scan.SC_HI + q] = hi
    return jnp.asarray(scal)


def _expect(groups, vals, counts, n_groups, monos, preds, ranges):
    """NumPy oracle: per group, each monomial's sum, then the count."""
    out = np.zeros((n_groups, len(monos) + 1), np.int64)
    for s, n in enumerate(counts):
        keep = np.ones(n, bool)
        for (lo, hi), p in zip(ranges, preds):
            keep &= (vals[p][s, :n] >= lo) & (vals[p][s, :n] <= hi)
        g = groups[s, :n]
        for k in range(n_groups):
            m = keep & (g == k)
            for mi, mono in enumerate(monos):
                term = np.ones(n, np.int64)
                for p in mono:
                    term = term * vals[p][s, :n]
                out[k, mi] += term[m].sum()
            out[k, -1] += m.sum()
    return out


@pytest.mark.parametrize("width", [1, 7, 8, 16, 17, 24, 31, 32])
def test_multi_scan_widths_match_numpy(width):
    """Every value width, a ragged tail segment, a range predicate."""
    rng = np.random.default_rng(width)
    counts = [SEG_ROWS, SEG_ROWS, 5000]
    G = 5
    g = rng.integers(0, G, (3, SEG_ROWS))
    codes = rng.integers(0, 1 << width, (3, SEG_ROWS), dtype=np.int64)
    vmin = 1000
    span = (1 << width) - 1
    lo, hi = vmin + span // 5, vmin + span - span // 7
    gst = _planes([g], [3], counts)
    vst = _planes([codes], [width], counts)
    out = gpu_scan.multi_scan(gst, vst, _scal(counts, [0], [vmin],
                                              [(lo, hi)]),
                              G, (1,), ((0,),), (0,), interpret=True)
    exp = _expect(g, [codes + vmin], counts, G, ((0,),), (0,), [(lo, hi)])
    np.testing.assert_array_equal(np.asarray(out), exp)


@pytest.mark.parametrize("lo,hi", [(500, 499), (123, 123)],
                         ids=["empty", "equality"])
def test_multi_scan_empty_and_equality_ranges(lo, hi):
    rng = np.random.default_rng(3)
    counts = [SEG_ROWS, 7000]
    g = rng.integers(0, 2, (2, SEG_ROWS))
    v = rng.integers(0, 1000, (2, SEG_ROWS))
    out = gpu_scan.multi_scan(
        _planes([g], [1], counts), _planes([v], [10], counts),
        _scal(counts, [0], [0], [(lo, hi)]), 2, (1,), ((0,),), (0,),
        interpret=True)
    exp = _expect(g, [v], counts, 2, ((0,),), (0,), [(lo, hi)])
    np.testing.assert_array_equal(np.asarray(out), exp)
    if lo > hi:
        assert not np.asarray(out).any()


def test_multi_scan_q1_shape_two_group_planes_degree3():
    """Two group planes (stride 2), a zero-width (constant) value plane,
    monomials of degree 1-3 and a predicate on a fourth plane."""
    rng = np.random.default_rng(11)
    counts = [SEG_ROWS, SEG_ROWS, 3000]
    rf = rng.integers(0, 3, (3, SEG_ROWS))
    ls = rng.integers(0, 2, (3, SEG_ROWS))
    price = rng.integers(0, 1 << 20, (3, SEG_ROWS))
    disc = rng.integers(0, 11, (3, SEG_ROWS))
    tax = np.zeros((3, SEG_ROWS), np.int64)  # constant plane: width 0
    ship = rng.integers(0, 2000, (3, SEG_ROWS))
    monos = ((0,), (0, 1), (0, 1, 2))
    gst = _planes([rf, ls], [2, 1], counts)
    vst = _planes([price, disc, tax, ship], [20, 4, 0, 11], counts)
    vmins = [90000, 0, 7, 10000]
    out = gpu_scan.multi_scan(
        gst, vst, _scal(counts, [0, 0], vmins, [(10100, 11500)]),
        6, (2, 1), monos, (3,), interpret=True)
    vals = [price + 90000, disc, tax + 7, ship + 10000]
    exp = _expect(rf * 2 + ls, vals, counts, 6, monos, (3,),
                  [(10100, 11500)])
    np.testing.assert_array_equal(np.asarray(out), exp)


@pytest.mark.parametrize("groups,outs,lanes", [
    (1, 2, 2048), (8, 7, 2048), (16, 7, 2048), (16, 9, 96), (2, 2, 32)])
def test_lane_tile_fits_lanes_and_registers(groups, outs, lanes):
    t = gpu_scan._lane_tile(groups, outs, lanes)
    assert t >= 1 and t & (t - 1) == 0 and lanes % t == 0
    assert t <= 1024 and (t <= 32 or groups * outs * t <= 4096)


# ---------------- the executor's choice of the kernel ----------------


def _li_db(mode, n=20_000, nulls=False):
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    cfg.fused_scan_kernel = mode
    db = at.Database(config=cfg)
    con = db.connect()
    rng = np.random.default_rng(5)
    con.query("CREATE TABLE li(g INTEGER, qty DECIMAL(12,2), "
              "price DECIMAL(12,2), ship DATE)")
    cols = {"g": rng.integers(0, 4, n).astype(np.int32),
            "qty": rng.integers(100, 5001, n),
            "price": rng.integers(9000, 200_000, n),
            "ship": rng.integers(10000, 11000, n)}
    app = con.appender("li")
    app.append_columns(cols, validity={"qty": rng.random(n) < 0.9}
                       if nulls else None)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


Q = ("SELECT g, sum(qty), sum(price * qty), count(*) FROM li "
     "WHERE ship < 10700 GROUP BY g ORDER BY g")


def _ran(db, con, sql):
    before = db.dist_stats.get("fused_multi_agg", 0)
    rows = con.query(sql).fetchall()
    return rows, db.dist_stats.get("fused_multi_agg", 0) > before


def test_kernel_interpret_mode_matches_xla_path():
    db, con = _li_db("interpret")
    got, ran = _ran(db, con, Q)
    assert ran and db.dist_stats["device_scan_agg_cpu"] >= 1
    con.query("SET fused_scan_kernel = 'off'")
    exp, ran_off = _ran(db, con, Q)
    assert not ran_off and got == exp and len(got) == 4
    db.close()


def test_kernel_choice_gpu_mode_off_the_gpu_uses_xla():
    db, con = _li_db("gpu")
    _rows, ran = _ran(db, con, Q)
    assert not ran and db.dist_stats["device_scan_agg"] >= 1
    db.close()


def test_kernel_choice_one_column_ungrouped_uses_xla():
    db, con = _li_db("interpret")
    rows, ran = _ran(db, con, "SELECT count(*), sum(price) FROM li")
    assert not ran and int(rows[0][0]) == 20_000
    _rows, ran = _ran(db, con, "SELECT sum(price * qty) FROM li "
                      "WHERE ship < 10500")
    assert ran
    db.close()


def test_kernel_choice_declines_null_planes():
    db, con = _li_db("interpret", nulls=True)
    got, ran = _ran(db, con, Q)
    assert not ran
    con.query("SET fused_scan_kernel = 'off'")
    assert got == con.query(Q).fetchall()
    db.close()


def test_fused_scan_kernel_setting_validates():
    cfg = at.DBConfig()
    cfg.set_option("fused_scan_kernel", "'OFF'")
    assert cfg.fused_scan_kernel == "off"
    with pytest.raises(ValueError, match="gpu|off|interpret"):
        cfg.set_option("fused_scan_kernel", "cuda")
