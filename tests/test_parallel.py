"""Multi-chip layer tests on the 8-device virtual CPU mesh (SURVEY.md §4:
single-chip goldens -> multi-chip-on-one-host via device mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adacom import types as tt
from adacom.ops import bitpack, segcodec
from adacom.parallel import mesh as pmesh
from adacom.parallel import ops as pops


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return pmesh.make_mesh(8)


def _pack_segments(rng, n_seg, seg_rows, width_span):
    packs = []
    datas = []
    for s in range(n_seg):
        base = rng.integers(0, 1 << 20)
        vals = (base + rng.integers(0, width_span, seg_rows)).astype(np.uint32)
        datas.append(vals)
        packs.append(segcodec.pack_segment(jnp.asarray(vals), tt.UINTEGER))
    return packs, datas


def test_distributed_scan_agg_matches_numpy(mesh8, rng):
    seg_rows = 1024
    n_seg = 16
    packs, datas = _pack_segments(rng, n_seg, seg_rows, 1 << 13)
    widths = packs[0].widths
    assert all(p.widths == widths for p in packs)
    n_lanes = packs[0].n_lanes
    words, mins, counts = pops.stack_packed_segments(packs, n_lanes)
    words = pmesh.shard_leading(mesh8, words)
    mins = pmesh.shard_leading(mesh8, mins)
    counts = pmesh.shard_leading(mesh8, counts)

    thresh = np.uint32(1 << 19)
    pred = lambda v, params: v < params
    fn = pops.make_distributed_scan_agg(mesh8, widths, n_lanes, predicate=pred)
    s, c = fn(words, mins, counts, thresh)

    all_vals = np.concatenate(datas)
    m = all_vals < thresh
    assert int(c) == int(m.sum())
    assert int(s) == int(all_vals[m].astype(np.int64).sum())


def test_hash_repartition_roundtrip(mesh8, rng):
    n_dev = 8
    n_local = 256
    n = n_dev * n_local
    keys = rng.integers(0, 1 << 30, n).astype(np.int64)
    vals = rng.integers(0, 1 << 30, n).astype(np.int64)
    valid = np.ones(n, dtype=bool)
    valid[::17] = False
    capacity = 128
    fn = pops.make_hash_repartition(mesh8, capacity, n_payloads=1)
    k_out, v_out, overflow, p_out = fn(
        pmesh.shard_leading(mesh8, jnp.asarray(keys)),
        pmesh.shard_leading(mesh8, jnp.asarray(valid)),
        pmesh.shard_leading(mesh8, jnp.asarray(vals)),
    )
    assert int(np.asarray(overflow).sum()) == 0
    k_np = np.asarray(k_out).reshape(n_dev, n_dev, capacity)
    v_np = np.asarray(v_out).reshape(n_dev, n_dev, capacity)
    p_np = np.asarray(p_out).reshape(n_dev, n_dev, capacity)
    # every valid row lands on the device its key hashes to
    got = {}
    for d in range(n_dev):
        for src in range(n_dev):
            for j in range(capacity):
                if v_np[d, src, j]:
                    got[(int(k_np[d, src, j]), int(p_np[d, src, j]))] = d
    assert len(got) == int(valid.sum())
    h = np.asarray(pops._hash64(jnp.asarray(keys)))
    for (k, p), d in got.items():
        i = np.nonzero((keys == k) & (vals == p))[0][0]
        assert int(h[i] % n_dev) == d


def test_distributed_groupby_sum(mesh8, rng):
    n_dev = 8
    n = n_dev * 512
    domain = 64
    keys = rng.integers(0, domain, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    fn = pops.make_distributed_groupby_sum(mesh8, capacity=n, domain=domain)
    sums, cnts = fn(
        pmesh.shard_leading(mesh8, jnp.asarray(keys)),
        pmesh.shard_leading(mesh8, jnp.asarray(valid)),
        pmesh.shard_leading(mesh8, jnp.asarray(vals)),
    )
    sums = np.asarray(sums)
    cnts = np.asarray(cnts)
    exp_sums = np.zeros(domain, np.int64)
    exp_cnts = np.zeros(domain, np.int64)
    np.add.at(exp_sums, keys[valid], vals[valid])
    np.add.at(exp_cnts, keys[valid], 1)
    np.testing.assert_array_equal(sums, exp_sums)
    np.testing.assert_array_equal(cnts, exp_cnts)


def test_distributed_join(mesh8):
    rng = np.random.default_rng(12)
    nb, npr = 512, 2048
    build_keys = np.arange(nb, dtype=np.int64)
    build_vals = build_keys * 3 + 1
    probe_keys = rng.integers(0, nb * 2, npr).astype(np.int64)
    probe_vals = np.arange(npr, dtype=np.int64)
    join = pops.make_distributed_join(mesh8, capacity=npr)
    matched, bx, px, pk = join(
        pmesh.shard_leading(mesh8, jnp.asarray(build_keys)),
        pmesh.shard_leading(mesh8, jnp.ones(nb, bool)),
        pmesh.shard_leading(mesh8, jnp.asarray(build_vals)),
        pmesh.shard_leading(mesh8, jnp.asarray(probe_keys)),
        pmesh.shard_leading(mesh8, jnp.ones(npr, bool)),
        pmesh.shard_leading(mesh8, jnp.asarray(probe_vals)),
    )
    m = np.asarray(matched)
    assert m.sum() == (probe_keys < nb).sum()
    np.testing.assert_array_equal(np.asarray(bx)[m], np.asarray(pk)[m] * 3 + 1)


def test_distributed_topk(mesh8):
    rng = np.random.default_rng(13)
    n = 4096
    vals = rng.permutation(n).astype(np.int64)
    topk = pops.make_distributed_topk(mesh8, k=16)
    tv, tg = topk(pmesh.shard_leading(mesh8, jnp.asarray(vals)),
                  pmesh.shard_leading(mesh8, jnp.ones(n, bool)))
    np.testing.assert_array_equal(np.asarray(tv), np.arange(n - 1, n - 17, -1))
    np.testing.assert_array_equal(vals[np.asarray(tg)], np.asarray(tv))


def test_groupby_preagg_skew_immune(mesh8):
    # 95% of rows share one key: the combiner path must stay exact
    rng = np.random.default_rng(14)
    n = 8192
    domain = 16
    keys = np.where(rng.random(n) < 0.95, 3,
                    rng.integers(0, domain, n)).astype(np.int64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    gb = pops.make_distributed_groupby_preagg(mesh8, domain=domain)
    sums, cnts = gb(pmesh.shard_leading(mesh8, jnp.asarray(keys)),
                    pmesh.shard_leading(mesh8, jnp.ones(n, bool)),
                    pmesh.shard_leading(mesh8, jnp.asarray(vals)))
    exp = np.zeros(domain, np.int64)
    np.add.at(exp, keys, vals)
    np.testing.assert_array_equal(np.asarray(sums), exp)


def test_sample_hot_keys():
    rng = np.random.default_rng(15)
    keys = np.where(rng.random(100_000) < 0.6, 42,
                    rng.integers(0, 10_000, 100_000)).astype(np.int64)
    hot = pops.sample_hot_keys(keys, n_dev=8)
    assert 42 in hot and len(hot) <= 4


def test_distributed_scan_agg_two_plane_validity(mesh8, rng):
    """BIGINT (lo/hi two-plane) segments with a packed validity plane ride
    the same SPMD kernel (VERDICT r03 weak #7: the standalone distributed
    scan-agg only handled single-plane u32)."""
    seg_rows = 512
    n_seg = 16
    packs, datas, vbits = [], [], []
    for s in range(n_seg):
        base = (1 << 40) + int(rng.integers(0, 1 << 20))
        vals = (base + rng.integers(0, 1 << 34, seg_rows)).astype(np.int64)
        valid = rng.random(seg_rows) > 0.1
        datas.append(vals)
        vbits.append(valid)
        packs.append(segcodec.pack_segment(jnp.asarray(vals), tt.BIGINT))
    widths = packs[0].widths
    assert len(widths) == 2 and all(p.widths == widths for p in packs)
    n_lanes = packs[0].n_lanes
    words, mins, counts = pops.stack_packed_segments(packs, n_lanes)
    vplanes = jnp.stack([
        bitpack.pack(bitpack.pad_codes(
            jnp.asarray(v.astype(np.uint32)), n_lanes), width=1)
        for v in vbits
    ])
    thresh = np.int64((1 << 40) + (1 << 33))
    pred = lambda v, params: v < params
    fn = pops.make_distributed_scan_agg(mesh8, widths, n_lanes,
                                        predicate=pred, has_validity=True)
    s, c = fn(pmesh.shard_leading(mesh8, words),
              pmesh.shard_leading(mesh8, vplanes),
              pmesh.shard_leading(mesh8, mins),
              pmesh.shard_leading(mesh8, counts), thresh)
    all_vals = np.concatenate(datas)
    all_valid = np.concatenate(vbits)
    m = all_valid & (all_vals < thresh)
    assert int(c) == int(m.sum())
    assert int(s) == int(all_vals[m].sum())
