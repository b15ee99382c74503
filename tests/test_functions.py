"""Scalar-function stdlib tests (reference: src/function/scalar/**).

Math/string/date function coverage over the dictionary substrate (strings)
and device kernels (numeric/date), verified against Python/NumPy."""

import datetime
import math

import numpy as np
import pytest

import adacom as at


@pytest.fixture()
def con():
    db = at.Database()
    c = db.connect()
    yield c
    db.close()


def one(con, sql):
    return con.query(sql).fetchone()[0]


# ---------------- math ----------------

def test_math_functions(con):
    con.query("CREATE TABLE m(x DOUBLE, i BIGINT)")
    con.query("INSERT INTO m VALUES (2.25, 10), (0.49, -7), (9.0, 22)")
    rows = con.query(
        "SELECT sqrt(x), exp(x), ln(x), log(100.0), log2(i*0+8), "
        "power(x, 2), sign(i), trunc(x), cbrt(8.0) FROM m"
    ).fetchall()
    xs = [2.25, 0.49, 9.0]
    is_ = [10, -7, 22]
    for r, x, i in zip(rows, xs, is_):
        assert r[0] == pytest.approx(math.sqrt(x))
        assert r[1] == pytest.approx(math.exp(x))
        assert r[2] == pytest.approx(math.log(x))
        assert r[3] == pytest.approx(2.0)
        assert r[4] == pytest.approx(3.0)
        assert r[5] == pytest.approx(x * x)
        assert int(r[6]) == (1 if i > 0 else -1)
        assert r[7] == float(int(x))
        assert r[8] == pytest.approx(2.0)


def test_trig_and_pi(con):
    con.query("CREATE TABLE t(x DOUBLE)")
    con.query("INSERT INTO t VALUES (0.5)")
    r = con.query(
        "SELECT sin(x), cos(x), tan(x), atan(x), atan2(x, 1.0), "
        "degrees(pi()), radians(180.0), pi() FROM t").fetchone()
    assert r[0] == pytest.approx(math.sin(0.5))
    assert r[1] == pytest.approx(math.cos(0.5))
    assert r[2] == pytest.approx(math.tan(0.5))
    assert r[3] == pytest.approx(math.atan(0.5))
    assert r[4] == pytest.approx(math.atan2(0.5, 1.0))
    assert r[5] == pytest.approx(180.0)
    assert r[6] == pytest.approx(math.pi)
    assert r[7] == pytest.approx(math.pi)


def test_mod_trunc_semantics(con):
    con.query("CREATE TABLE md(a BIGINT, b BIGINT)")
    con.query("INSERT INTO md VALUES (7, 3), (-7, 3), (7, -3), (-7, -3), (5, 0)")
    rows = [r[0] for r in con.query("SELECT mod(a, b) FROM md").fetchall()]
    # SQL mod follows the dividend's sign (truncated division); x % 0 is NULL
    assert rows == [1, -1, 1, -1, None]


def test_greatest_least(con):
    con.query("CREATE TABLE g(a BIGINT, b BIGINT, c BIGINT)")
    con.query("INSERT INTO g VALUES (1, 5, 3), (9, NULL, 2), (NULL, NULL, 4)")
    rows = con.query("SELECT greatest(a, b, c), least(a, b, c) FROM g").fetchall()
    assert [tuple(r) for r in rows] == [(5, 1), (9, 2), (4, 4)]


def test_nullif_ifnull_iif(con):
    con.query("CREATE TABLE n(a BIGINT, b BIGINT)")
    con.query("INSERT INTO n VALUES (1, 1), (2, 3), (NULL, 5)")
    rows = con.query(
        "SELECT nullif(a, b), ifnull(a, 0), iif(a = b, 100, 200) FROM n"
    ).fetchall()
    assert [tuple(r) for r in rows] == [(None, 1, 100), (2, 2, 200),
                                        (None, 0, 200)]


# ---------------- strings ----------------

def test_string_functions(con):
    con.query("CREATE TABLE s(v VARCHAR)")
    con.query("INSERT INTO s VALUES ('hello world'), ('Ab'), (''), (NULL)")
    rows = con.query(
        "SELECT length(v), upper(v), reverse(v), left(v, 3), right(v, 3), "
        "lpad(v, 5, '*'), repeat(v, 2), replace(v, 'l', 'L') FROM s"
    ).fetchall()
    vals = ["hello world", "Ab", ""]
    for r, s in zip(rows, vals):
        assert r[0] == len(s)
        assert r[1] == s.upper()
        assert r[2] == s[::-1]
        assert r[3] == s[:3]
        assert r[4] == (s[len(s) - 3:] if len(s) >= 3 else s)
        assert r[5] == ("*" * 5)[: 5 - len(s)] + s if len(s) < 5 else s[:5]
        assert r[6] == s * 2
        assert r[7] == s.replace("l", "L")
    assert rows[3][0] is None


def test_split_part_initcap_strpos_ascii(con):
    con.query("CREATE TABLE sp(v VARCHAR)")
    con.query("INSERT INTO sp VALUES ('a,b,c'), ('one two'), ('x')")
    rows = con.query(
        "SELECT split_part(v, ',', 2), initcap(v), strpos(v, 'b'), "
        "ascii(v) FROM sp").fetchall()
    assert tuple(rows[0]) == ("b", "A,B,C", 3, ord("a"))
    assert tuple(rows[1]) == ("", "One Two", 0, ord("o"))
    assert tuple(rows[2]) == ("", "X", 0, ord("x"))


def test_string_predicates(con):
    con.query("CREATE TABLE p(v VARCHAR)")
    con.query("INSERT INTO p VALUES ('apple pie'), ('pieces'), ('grape'), (NULL)")
    assert [r[0] for r in con.query(
        "SELECT v FROM p WHERE contains(v, 'pie')").fetchall()] == \
        ["apple pie", "pieces"]
    assert [r[0] for r in con.query(
        "SELECT v FROM p WHERE starts_with(v, 'pie')").fetchall()] == \
        ["pieces"]
    assert [r[0] for r in con.query(
        "SELECT v FROM p WHERE ends_with(v, 'pie')").fetchall()] == \
        ["apple pie"]
    assert [r[0] for r in con.query(
        "SELECT v FROM p WHERE regexp_matches(v, '^g.*e$')").fetchall()] == \
        ["grape"]


# ---------------- dates ----------------

def test_date_extraction(con):
    con.query("CREATE TABLE d(dt DATE)")
    con.query("INSERT INTO d VALUES ('1996-03-13'), ('2000-12-31'), "
              "('1970-01-01')")
    rows = con.query(
        "SELECT year(dt), quarter(dt), week(dt), dayofweek(dt), "
        "dayofyear(dt), epoch(dt) FROM d").fetchall()
    for r, iso in zip(rows, ["1996-03-13", "2000-12-31", "1970-01-01"]):
        dt = datetime.date.fromisoformat(iso)
        assert r[0] == dt.year
        assert r[1] == (dt.month + 2) // 3
        assert r[2] == dt.isocalendar()[1]
        assert r[3] == (dt.weekday() + 1) % 7  # Sunday = 0
        assert r[4] == dt.timetuple().tm_yday
        assert r[5] == int(datetime.datetime(
            dt.year, dt.month, dt.day,
            tzinfo=datetime.timezone.utc).timestamp())


def test_date_trunc_last_day_diff(con):
    con.query("CREATE TABLE d2(a DATE, b DATE)")
    con.query("INSERT INTO d2 VALUES ('1996-03-13', '1998-07-02')")
    r = con.query(
        "SELECT date_trunc('month', a), date_trunc('year', a), "
        "date_trunc('quarter', b), date_trunc('week', a), last_day(a), "
        "date_diff('day', a, b), date_diff('month', a, b), "
        "date_diff('year', a, b) FROM d2").fetchone()
    a = datetime.date(1996, 3, 13)
    b = datetime.date(1998, 7, 2)
    assert str(r[0]) == "1996-03-01"
    assert str(r[1]) == "1996-01-01"
    assert str(r[2]) == "1998-07-01"
    assert str(r[3]) == "1996-03-11"  # Monday of that week
    assert str(r[4]) == "1996-03-31"
    assert r[5] == (b - a).days
    assert r[6] == (1998 * 12 + 7) - (1996 * 12 + 3)
    assert r[7] == 2


def test_monthname_dayname(con):
    con.query("CREATE TABLE d3(dt DATE)")
    con.query("INSERT INTO d3 VALUES ('1996-03-13'), ('2000-12-31')")
    rows = con.query("SELECT monthname(dt), dayname(dt) FROM d3").fetchall()
    assert tuple(rows[0]) == ("March", "Wednesday")
    assert tuple(rows[1]) == ("December", "Sunday")


def test_functions_in_where_and_groupby(con):
    con.query("CREATE TABLE w(v VARCHAR, x BIGINT)")
    con.query("INSERT INTO w VALUES ('aa', 1), ('bbb', 2), ('cc', 3), "
              "('dddd', 4)")
    assert one(con, "SELECT sum(x) FROM w WHERE length(v) = 2") == 4
    rows = con.query(
        "SELECT length(v) AS l, sum(x) FROM w GROUP BY l ORDER BY l"
    ).fetchall()
    assert [tuple(r) for r in rows] == [(2, 4), (3, 2), (4, 4)]
