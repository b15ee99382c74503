"""Distributed query operators: SPMD scan/aggregate, all-to-all shuffle,
hash-partitioned group-by, broadcast joins.

Design per SURVEY.md §5.8: segments shard over the mesh's segment axis;
each device decodes + filters + partially aggregates its local segments
(vmap over the segment dim — the fused kernel is the same one single-chip
scans use), and partial states merge with `psum` inside `shard_map`.
Repartitioning uses `all_to_all` on fixed-capacity bins with validity
masks (static shapes; skew handling = capacity headroom + overflow count
reporting)."""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from adacom.parallel.mesh import SEG_AXIS
from adacom.ops import bitpack


# ======================================================================
# distributed scan + aggregate
# ======================================================================


def make_distributed_scan_agg(mesh, widths: Tuple[int, ...], n_lanes: int,
                              agg: str = "sum_count",
                              predicate: Optional[Callable] = None,
                              has_validity: bool = False):
    """Build a jitted SPMD scan-aggregate over stacked packed segments.

    Inputs (sharded over the segment axis on dim 0):
      words:  (n_seg, width_total, n_lanes) uint32 — stacked packed planes
      mins:   (n_seg,) frame-of-reference minima
      counts: (n_seg,) valid row counts
    plus replicated predicate params. Output: replicated aggregate.

    The per-device body decodes with the same vertical-layout kernel as
    single-chip scans (ops/segcodec.decode_traced — every representation
    class: one or two planes, constant planes, 64-bit lo/hi) and
    psum-merges partials — the reference's local/global sink state merge
    (SURVEY.md §2.2) mapped onto mesh collectives. `has_validity` adds a
    width-1-packed validity plane input whose zero rows are excluded."""
    from adacom.ops import segcodec

    n_pad = bitpack.ROWS * n_lanes
    compute = jnp.int64 if len(widths) == 2 else jnp.uint32
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)

    def seg_partial(words, vplane, mn, count, params):
        planes = tuple(
            words[offs[i]:offs[i + 1]] if widths[i] else None
            for i in range(len(widths))
        )
        vals = segcodec.decode_traced(planes, mn, widths=widths,
                                      compute_dtype=compute)
        idx = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0).squeeze(-1)
        mask = idx < count
        if vplane is not None:
            vbits = bitpack.unpack(vplane, width=1).reshape(-1)
            mask = mask & (vbits != 0)
        if predicate is not None:
            mask = mask & predicate(vals, params)
        cnt = jnp.sum(mask.astype(jnp.int64))
        s = jnp.sum(jnp.where(mask, vals.astype(jnp.int64), 0))
        return s, cnt

    if has_validity:
        def device_body(words, valid, mins, counts, params):
            s, c = jax.vmap(seg_partial, in_axes=(0, 0, 0, 0, None))(
                words, valid, mins, counts, params
            )
            return (jax.lax.psum(jnp.sum(s), SEG_AXIS),
                    jax.lax.psum(jnp.sum(c), SEG_AXIS))

        in_specs = (P(SEG_AXIS, None, None), P(SEG_AXIS, None, None),
                    P(SEG_AXIS), P(SEG_AXIS), P())
    else:
        def device_body(words, mins, counts, params):
            s, c = jax.vmap(
                lambda w, m, n, p: seg_partial(w, None, m, n, p),
                in_axes=(0, 0, 0, None))(words, mins, counts, params)
            return (jax.lax.psum(jnp.sum(s), SEG_AXIS),
                    jax.lax.psum(jnp.sum(c), SEG_AXIS))

        in_specs = (P(SEG_AXIS, None, None), P(SEG_AXIS), P(SEG_AXIS), P())
    sharded = shard_map(device_body, mesh=mesh, in_specs=in_specs,
                        out_specs=(P(), P()))
    return jax.jit(sharded)


def stack_packed_segments(packed_list, n_lanes: int):
    """Stack same-width PackedData into (n_seg, sum(w), L) + minima +
    counts. Multi-plane segments concatenate their planes on the word
    axis (matching make_distributed_scan_agg's width offsets); constant
    (width-0) planes contribute no words."""
    words = jnp.stack([
        jnp.concatenate([w for w in p.words if w is not None], axis=0)
        if sum(1 for w in p.words if w is not None) > 1
        else next(w for w in p.words if w is not None)
        for p in packed_list
    ])
    mins = jnp.asarray([p.min_factor for p in packed_list], dtype=jnp.int64)
    counts = jnp.asarray([p.count for p in packed_list], dtype=jnp.int32)
    return words, mins, counts


# ======================================================================
# all-to-all hash repartition (the exchange operator)
# ======================================================================


def make_hash_repartition(mesh, capacity: int, n_payloads: int = 0):
    """Build a jitted SPMD hash-repartition.

    Each device bins its local (keys, payloads...) rows by
    `hash(key) % n_devices` into fixed-capacity bins, then all_to_all
    exchanges bins so device i ends up with every row whose key hashes to
    i. Static shapes: each device sends exactly `capacity` slots per
    destination; real rows are flagged by the returned validity mask, and
    per-destination overflow counts are returned for skew diagnostics
    (skew-aware re-splitting is a later milestone)."""
    n_dev = mesh.devices.size

    def device_body(keys, valid, *payloads):
        # keys: (n_local,) int64; valid: (n_local,) bool
        h = _hash64(keys)
        dest = (h % np.uint64(n_dev)).astype(jnp.int32)
        dest = jnp.where(valid, dest, n_dev)  # invalid rows -> dropped
        # stable order of rows per destination bin
        slot_in_dest = _rank_within(dest, n_dev + 1, keys.shape[0])
        target = dest * capacity + jnp.minimum(slot_in_dest, capacity - 1)
        overflow = jnp.zeros((n_dev,), jnp.int32).at[jnp.minimum(dest, n_dev - 1)].add(
            ((slot_in_dest >= capacity) & (dest < n_dev)).astype(jnp.int32)
        )
        drop = (dest >= n_dev) | (slot_in_dest >= capacity)
        target = jnp.where(drop, n_dev * capacity, target)

        def scatter(x, fill):
            out = jnp.full((n_dev * capacity + 1,), fill, x.dtype)
            out = out.at[target].set(x, mode="drop")
            return out[:-1].reshape(n_dev, capacity)

        k_bins = scatter(keys, jnp.zeros((), keys.dtype))
        v_bins = scatter(valid & ~drop, jnp.zeros((), jnp.bool_))
        p_bins = [scatter(p, jnp.zeros((), p.dtype)) for p in payloads]

        # exchange: dim 0 = destination device
        k_out = jax.lax.all_to_all(k_bins, SEG_AXIS, 0, 0, tiled=True)
        v_out = jax.lax.all_to_all(v_bins, SEG_AXIS, 0, 0, tiled=True)
        p_out = [jax.lax.all_to_all(p, SEG_AXIS, 0, 0, tiled=True) for p in p_bins]
        return (k_out, v_out, jax.lax.psum(overflow, SEG_AXIS), *p_out)

    out_specs = (P(SEG_AXIS), P(SEG_AXIS), P()) + tuple(
        P(SEG_AXIS) for _ in range(n_payloads)
    )
    sharded = shard_map(
        device_body,
        mesh=mesh,
        in_specs=(P(SEG_AXIS), P(SEG_AXIS)) + tuple(P(SEG_AXIS) for _ in range(n_payloads)),
        out_specs=out_specs,
    )
    return jax.jit(sharded)


def make_distributed_groupby_sum(mesh, capacity: int, domain: int):
    """Hash-repartition keys, then dense scatter-add per device, then
    all_gather the per-device dense partials masked to owned keys.

    Returns jitted fn(keys(int64 sharded), valid, values(int64 sharded)) ->
    (sums (domain,), counts (domain,)) replicated. Keys must lie in
    [0, domain)."""
    n_dev = mesh.devices.size
    repart = None  # fused below

    def device_body(keys, valid, values):
        h = _hash64(keys)
        dest = (h % np.uint64(n_dev)).astype(jnp.int32)
        dest = jnp.where(valid, dest, n_dev)
        slot = _rank_within(dest, n_dev + 1, keys.shape[0])
        drop = (dest >= n_dev) | (slot >= capacity)
        target = jnp.where(drop, n_dev * capacity, dest * capacity + jnp.minimum(slot, capacity - 1))

        def scatter(x, fill):
            out = jnp.full((n_dev * capacity + 1,), fill, x.dtype)
            out = out.at[target].set(x, mode="drop")
            return out[:-1].reshape(n_dev, capacity)

        k_b = scatter(keys, jnp.zeros((), keys.dtype))
        v_b = scatter(valid & ~drop, jnp.zeros((), jnp.bool_))
        x_b = scatter(values, jnp.zeros((), values.dtype))
        k_r = jax.lax.all_to_all(k_b, SEG_AXIS, 0, 0, tiled=True).reshape(-1)
        v_r = jax.lax.all_to_all(v_b, SEG_AXIS, 0, 0, tiled=True).reshape(-1)
        x_r = jax.lax.all_to_all(x_b, SEG_AXIS, 0, 0, tiled=True).reshape(-1)
        # local dense aggregate over owned keys
        gid = jnp.where(v_r, k_r.astype(jnp.int32), domain)
        sums = jnp.zeros((domain + 1,), values.dtype).at[gid].add(
            jnp.where(v_r, x_r, jnp.zeros((), values.dtype))
        )[:domain]
        cnts = jnp.zeros((domain + 1,), jnp.int64).at[gid].add(
            v_r.astype(jnp.int64)
        )[:domain]
        # each key lives on exactly one device -> psum merges disjoint stripes
        return jax.lax.psum(sums, SEG_AXIS), jax.lax.psum(cnts, SEG_AXIS)

    sharded = shard_map(
        device_body, mesh=mesh,
        in_specs=(P(SEG_AXIS), P(SEG_AXIS), P(SEG_AXIS)),
        out_specs=(P(), P()),
    )
    return jax.jit(sharded)


def make_distributed_groupby_preagg(mesh, domain: int):
    """Skew-immune distributed group-by for dense key domains: each device
    pre-aggregates its local rows into a (domain,) dense partial, then one
    psum merges — no all_to_all, no per-key routing, so a 99%-hot key costs
    the same as a uniform one (the classic combiner fix for skewed
    shuffles; the reference's perfect-hash aggregate analogue,
    physical_perfecthash_aggregate, distributed)."""

    def device_body(keys, valid, values):
        gid = jnp.where(valid, keys.astype(jnp.int32), domain)
        sums = jnp.zeros((domain + 1,), values.dtype).at[gid].add(
            jnp.where(valid, values, jnp.zeros((), values.dtype)))[:domain]
        cnts = jnp.zeros((domain + 1,), jnp.int64).at[gid].add(
            valid.astype(jnp.int64))[:domain]
        return jax.lax.psum(sums, SEG_AXIS), jax.lax.psum(cnts, SEG_AXIS)

    sharded = shard_map(
        device_body, mesh=mesh,
        in_specs=(P(SEG_AXIS), P(SEG_AXIS), P(SEG_AXIS)),
        out_specs=(P(), P()),
    )
    return jax.jit(sharded)


# ======================================================================
# distributed hash join (shuffle join: repartition both sides, join local)
# ======================================================================


def make_distributed_join(mesh, capacity: int):
    """Build a jitted SPMD equi-join for a unique-key build side (PK-FK,
    the reference JoinHashTable's perfect/unique fast path distributed).

    Both sides hash-repartition by key over the mesh (all_to_all on
    fixed-capacity bins), so matching keys land on the same device; the
    local join sorts the build partition once and answers probes with a
    searchsorted binary search — static shapes end to end, no dynamic
    hash-table growth (SURVEY.md §7 hard part #1).

    fn(build_keys, build_valid, build_vals, probe_keys, probe_valid,
       probe_vals) -> (matched(bool), build_val_for_probe, probe_vals,
       probe_keys) all sharded like the probe side after repartition.
    """
    n_dev = mesh.devices.size

    def repart(keys, valid, *payloads):
        h = _hash64(keys)
        dest = (h % np.uint64(n_dev)).astype(jnp.int32)
        dest = jnp.where(valid, dest, n_dev)
        slot = _rank_within(dest, n_dev + 1, keys.shape[0])
        drop = (dest >= n_dev) | (slot >= capacity)
        target = jnp.where(drop, n_dev * capacity,
                           dest * capacity + jnp.minimum(slot, capacity - 1))

        def scatter(x, fill):
            out = jnp.full((n_dev * capacity + 1,), fill, x.dtype)
            out = out.at[target].set(x, mode="drop")
            return out[:-1].reshape(n_dev, capacity)

        outs = [scatter(keys, jnp.zeros((), keys.dtype)),
                scatter(valid & ~drop, jnp.zeros((), jnp.bool_))]
        outs += [scatter(x, jnp.zeros((), x.dtype)) for x in payloads]
        return [jax.lax.all_to_all(o, SEG_AXIS, 0, 0, tiled=True).reshape(-1)
                for o in outs]

    def device_body(bk, bv, bx, pk, pv, px):
        bk_r, bv_r, bx_r = repart(bk, bv, bx)
        pk_r, pv_r, px_r = repart(pk, pv, px)
        # local join: sort build partition, binary-search each probe key
        sort_key = jnp.where(bv_r, bk_r, jnp.iinfo(bk_r.dtype).max)
        order = jnp.argsort(sort_key)
        sk = sort_key[order]
        sx = bx_r[order]
        pos = jnp.searchsorted(sk, pk_r)
        pos = jnp.minimum(pos, sk.shape[0] - 1)
        matched = pv_r & (sk[pos] == pk_r)
        return matched, jnp.where(matched, sx[pos], 0), px_r, pk_r

    sharded = shard_map(
        device_body, mesh=mesh,
        in_specs=tuple(P(SEG_AXIS) for _ in range(6)),
        out_specs=tuple(P(SEG_AXIS) for _ in range(4)),
    )
    return jax.jit(sharded)


def make_distributed_join_rowids(mesh, capacity: int):
    """Distributed equi-join keyed on 64-bit hashes with ROW-ID payloads —
    the general-purpose shuffle join the SQL executor routes through
    (build side must have unique hashes; the executor checks and falls
    back to the host join otherwise, and re-verifies true key equality
    afterwards for collision safety).

    fn(bk, bv, b_rid, pk, pv, p_rid) -> (matched, b_rid_out, p_rid_out,
    overflow) where the first three are sharded like the probe partition
    and `overflow` is the global count of rows dropped by bin-capacity
    limits — CALLERS MUST FALL BACK when overflow > 0 (skew guard)."""
    n_dev = mesh.devices.size

    def repart(keys, valid, payload):
        h = _hash64(keys)
        dest = (h % np.uint64(n_dev)).astype(jnp.int32)
        dest = jnp.where(valid, dest, n_dev)
        slot = _rank_within(dest, n_dev + 1, keys.shape[0])
        drop = (dest >= n_dev) | (slot >= capacity)
        ovf = jnp.sum(((slot >= capacity) & (dest < n_dev)).astype(jnp.int64))
        target = jnp.where(drop, n_dev * capacity,
                           dest * capacity + jnp.minimum(slot, capacity - 1))

        def scatter(x, fill):
            out = jnp.full((n_dev * capacity + 1,), fill, x.dtype)
            out = out.at[target].set(x, mode="drop")
            return out[:-1].reshape(n_dev, capacity)

        outs = [scatter(keys, jnp.zeros((), keys.dtype)),
                scatter(valid & ~drop, jnp.zeros((), jnp.bool_)),
                scatter(payload, jnp.zeros((), payload.dtype))]
        return [jax.lax.all_to_all(o, SEG_AXIS, 0, 0, tiled=True).reshape(-1)
                for o in outs], ovf

    def device_body(bk, bv, br, pk, pv, pr):
        (bk_r, bv_r, br_r), ovf_b = repart(bk, bv, br)
        (pk_r, pv_r, pr_r), ovf_p = repart(pk, pv, pr)
        sort_key = jnp.where(bv_r, bk_r, jnp.iinfo(bk_r.dtype).max)
        order = jnp.argsort(sort_key)
        sk = sort_key[order]
        sr = br_r[order]
        sv = bv_r[order]
        pos = jnp.searchsorted(sk, pk_r)
        pos = jnp.minimum(pos, sk.shape[0] - 1)
        matched = pv_r & sv[pos] & (sk[pos] == pk_r)
        overflow = jax.lax.psum(ovf_b + ovf_p, SEG_AXIS)
        return (matched, jnp.where(matched, sr[pos], 0), pr_r, overflow)

    sharded = shard_map(
        device_body, mesh=mesh,
        in_specs=tuple(P(SEG_AXIS) for _ in range(6)),
        out_specs=(P(SEG_AXIS), P(SEG_AXIS), P(SEG_AXIS), P()),
    )
    return jax.jit(sharded)


# ======================================================================
# distributed top-k (global ORDER BY ... LIMIT k merge)
# ======================================================================


def make_distributed_topk(mesh, k: int, largest: bool = True):
    """Per-device lax.top_k over local rows, all_gather the n_dev*k
    candidates, final top_k replicated — the reference's per-block heap +
    merge (PhysicalTopN) on mesh collectives.

    fn(values sharded, valid sharded) -> (top values, global row ids)."""

    def device_body(values, valid, base):
        n_local = values.shape[0]
        neg = jnp.asarray(-(2 ** 62), values.dtype)
        v = values if largest else -values
        v = jnp.where(valid, v, neg)
        loc_v, loc_i = jax.lax.top_k(v, min(k, n_local))
        # global row ids: device offset + local index
        gid = base + loc_i.astype(jnp.int64)
        all_v = jax.lax.all_gather(loc_v, SEG_AXIS).reshape(-1)
        all_g = jax.lax.all_gather(gid, SEG_AXIS).reshape(-1)
        fin_v, fin_i = jax.lax.top_k(all_v, k)
        out_v = fin_v if largest else -fin_v
        return out_v, all_g[fin_i]

    def wrapper(values, valid):
        n_local = values.shape[0]  # per-device after sharding

        def body(v, m):
            dev = jax.lax.axis_index(SEG_AXIS).astype(jnp.int64)
            return device_body(v, m, dev * (v.shape[0]))

        return shard_map(body, mesh=mesh,
                         in_specs=(P(SEG_AXIS), P(SEG_AXIS)),
                         out_specs=(P(), P()),
                         check_vma=False)(values, valid)

    return jax.jit(wrapper)


def sample_hot_keys(keys: np.ndarray, n_dev: int, sample: int = 65536,
                    hot_factor: float = 4.0) -> np.ndarray:
    """Skew planner: sample the key stream and return keys whose estimated
    frequency exceeds hot_factor / n_dev of all rows (these overflow a
    single device's bin; the caller handles them via broadcast or salting
    — SURVEY.md §5.8 skew-aware splitting)."""
    keys = np.asarray(keys)
    if len(keys) > sample:
        idx = np.random.default_rng(0).integers(0, len(keys), sample)
        keys = keys[idx]
    uniq, cnt = np.unique(keys, return_counts=True)
    thresh = hot_factor * len(keys) / max(1, n_dev)
    return uniq[cnt > thresh]


def broadcast_small(mesh, arr):
    """Replicate a small build side to all devices (broadcast join side)."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


# ======================================================================
# helpers
# ======================================================================


def _hash64(x):
    """splitmix64 finalizer (vectorized)."""
    z = x.astype(jnp.uint64)
    z = (z ^ (z >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return z ^ (z >> jnp.uint64(31))


def _rank_within(dest, n_bins: int, n: int):
    """slot_in_dest[i] = number of earlier rows with the same dest.

    O(n_bins * n) elementwise via cumsum per bin — fine for small bin
    counts (device counts); a Pallas multi-split is a later milestone."""
    ranks = jnp.zeros((n,), jnp.int32)
    for b_ in range(n_bins):
        is_b = dest == b_
        r = jnp.cumsum(is_b.astype(jnp.int32)) - 1
        ranks = jnp.where(is_b, r, ranks)
    return ranks
