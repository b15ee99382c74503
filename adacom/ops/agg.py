"""Aggregation kernels: masked partial reductions + dense grouped scatter.

Parity with the reference's aggregate operators (src/execution/operator/
aggregate/*): the ungrouped path is a masked reduction per scan batch with
host-side partial merge (the reference's local/global sink states); the
grouped path uses the *perfect hash* strategy (reference
PerfectAggregateHashTable, perfect_hash_join_executor's sibling): group keys
with a small bounded domain become dense indices and aggregation is a
scatter-add (jnp .at[].add) over a (domain, n_aggs) grid, merged across
batches by elementwise addition. Large/unbounded domains fall back to a
host hash aggregate (radix-partitioned device hash tables are a later
milestone)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


def masked_sum(values, mask, acc_dtype):
    v = values.astype(acc_dtype)
    if mask is not None:
        v = jnp.where(mask, v, jnp.zeros((), acc_dtype))
    return jnp.sum(v)


def masked_count(mask, n):
    if mask is None:
        return jnp.asarray(n, jnp.int64)
    return jnp.sum(mask.astype(jnp.int64))


def masked_min(values, mask, acc_dtype, sentinel):
    v = values.astype(acc_dtype)
    if mask is not None:
        v = jnp.where(mask, v, jnp.asarray(sentinel, acc_dtype))
    return jnp.min(v)


def masked_max(values, mask, acc_dtype, sentinel):
    v = values.astype(acc_dtype)
    if mask is not None:
        v = jnp.where(mask, v, jnp.asarray(sentinel, acc_dtype))
    return jnp.max(v)


# ---------------- grouped (perfect-hash / dense domain) ----------------


def dense_group_ids(keys: List, mins: List, strides: List, domain: int):
    """Mixed-radix dense id for multi-column small-domain group keys."""
    gid = None
    for k, mn, st in zip(keys, mins, strides):
        part = (k.astype(jnp.int64) - mn) * st
        gid = part if gid is None else gid + part
    return jnp.clip(gid, 0, domain - 1).astype(jnp.int32)


# below this domain size, grouped partials use a one-hot masked reduction
# (a streaming reduce) instead of scatter-add; the limit is inherited and
# not yet measured on a GPU (ROADMAP 1.3)
ONEHOT_DOMAIN_LIMIT = 128


def grouped_partial(
    gid,            # (n,) int32 dense group ids
    mask,           # (n,) bool or None
    specs,          # list of (kind, values|None, acc_dtype)
    domain: int,
):
    """One batch's grouped partial state: tuple of (domain,)-shaped arrays.

    kinds: 'count' (needs mask only), 'sum', 'min', 'max', 'sumsq'."""
    if domain <= ONEHOT_DOMAIN_LIMIT:
        return _grouped_partial_onehot(gid, mask, specs, domain)
    outs = []
    ones = jnp.ones(gid.shape, jnp.int64)
    mask_i = ones if mask is None else mask.astype(jnp.int64)
    safe_gid = gid if mask is None else jnp.where(mask, gid, domain)
    for kind, values, acc_dtype in specs:
        if kind == "count":
            acc = jnp.zeros((domain + 1,), jnp.int64).at[safe_gid].add(mask_i)
            outs.append(acc[:domain])
            continue
        v = values.astype(acc_dtype)
        if kind == "sum":
            z = jnp.zeros((), acc_dtype)
            vv = v if mask is None else jnp.where(mask, v, z)
            acc = jnp.zeros((domain + 1,), acc_dtype).at[safe_gid].add(vv)
            outs.append(acc[:domain])
        elif kind == "sumsq":
            z = jnp.zeros((), acc_dtype)
            vv = v * v
            vv = vv if mask is None else jnp.where(mask, vv, z)
            acc = jnp.zeros((domain + 1,), acc_dtype).at[safe_gid].add(vv)
            outs.append(acc[:domain])
        elif kind == "min":
            sent = _max_sentinel(acc_dtype)
            acc = jnp.full((domain + 1,), sent, acc_dtype).at[safe_gid].min(v)
            outs.append(acc[:domain])
        elif kind == "max":
            sent = _min_sentinel(acc_dtype)
            acc = jnp.full((domain + 1,), sent, acc_dtype).at[safe_gid].max(v)
            outs.append(acc[:domain])
        else:
            raise ValueError(kind)
    return tuple(outs)


def _grouped_partial_onehot(gid, mask, specs, domain: int):
    """Grouped partials via (n, domain) one-hot masked reductions."""
    n = gid.shape[0]
    groups = jax.lax.broadcasted_iota(jnp.int32, (1, domain), 1)
    hot = gid[:, None] == groups  # (n, domain) bool
    if mask is not None:
        hot = hot & mask[:, None]
    outs = []
    for kind, values, acc_dtype in specs:
        if kind == "count":
            outs.append(jnp.sum(hot.astype(jnp.int64), axis=0))
            continue
        v = values.astype(acc_dtype)
        if kind in ("sum", "sumsq"):
            vv = v * v if kind == "sumsq" else v
            z = jnp.zeros((), acc_dtype)
            outs.append(jnp.sum(jnp.where(hot, vv[:, None], z), axis=0))
        elif kind == "min":
            sent = jnp.asarray(_max_sentinel(acc_dtype), acc_dtype)
            outs.append(jnp.min(jnp.where(hot, v[:, None], sent), axis=0))
        elif kind == "max":
            sent = jnp.asarray(_min_sentinel(acc_dtype), acc_dtype)
            outs.append(jnp.max(jnp.where(hot, v[:, None], sent), axis=0))
        else:
            raise ValueError(kind)
    return tuple(outs)


def _max_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).max if dt.kind == "f" else np.iinfo(dt).max


def _min_sentinel(dt):
    dt = np.dtype(dt)
    return np.finfo(dt).min if dt.kind == "f" else np.iinfo(dt).min


def merge_partials(kind: str, a, b_):
    if kind in ("count", "sum", "sumsq"):
        return a + b_
    if kind == "min":
        return jnp.minimum(a, b_)
    if kind == "max":
        return jnp.maximum(a, b_)
    raise ValueError(kind)
