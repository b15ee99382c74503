"""chip_smoke.py's phases at tiny sizes on the CPU: the control flow, the
oracle checks and the device-tier counters it relies on."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def log():
    return chip_smoke.SmokeLog("cpu")


def test_phase_zipf_small(log, capsys):
    chip_smoke.phase_zipf(300_000, 50, "cpu", log)
    out = capsys.readouterr().out
    assert "zipf full scan (hot 2)" in out
    assert "zipf scan step memory:" in out


def test_phase_tpch_small(log, capsys):
    chip_smoke.phase_tpch(0.01, "cpu", log)
    out = capsys.readouterr().out
    for label in ("Q1", "Q6", "group by l_linenumber"):
        assert f"tpch {label} (hot)" in out


@pytest.mark.mesh
def test_phase_mesh_small(log, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    chip_smoke.phase_mesh(4, 0.01, "cpu", log)
    out = capsys.readouterr().out
    assert "mesh segment pools on devices: ['cpu0', 'cpu1', 'cpu2', " \
        "'cpu3']" in out


def test_device_query_requires_platform(log):
    import adacom as at

    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (2), (3)")
    assert chip_smoke.device_query(db, con, "SELECT sum(i) FROM t",
                                   "cpu") == [(6,)]
    with pytest.raises(AssertionError, match="did not run on gpu"):
        chip_smoke.device_query(db, con, "SELECT sum(i) FROM t", "gpu")
    db.close()


@pytest.mark.parametrize("got,exp,ok", [
    ([(1, 2.0)], [(1, 2.0 * (1 + 1e-12))], True),
    ([(1, 2.0)], [(1, 2.0 * (1 + 1e-8))], False),
    ([(1, "A")], [(1, "A")], True),
    ([(1, None)], [(1, 0.0)], False),
    ([(2,)], [(2,), (3,)], False),
])
def test_rows_match(got, exp, ok):
    assert chip_smoke.rows_match(got, exp) is ok


def test_refuses_cpu():
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
