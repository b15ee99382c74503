"""Pallas (Triton route) fused decode + filter + grouped multi-aggregate.

One program per (segment, lane tile): it loads each plane's packed words
for its lanes (coalesced: ops/bitpack.py's vertical layout puts a lane
tile's words contiguously), unpacks the 32 rows with static shifts, applies
the conjunctive value-range predicates, and accumulates every monomial
product into int64 (groups, lanes) registers with a one-hot group mask.
Each program writes one (groups,) partial per output; an XLA epilogue sums
the partials. No state crosses programs and no atomics are used.

exec/executor.py::_try_fused_multi_agg routes grouped and multi-column
aggregate scans here on a GPU (DBConfig.fused_scan_kernel); on the H100
this beats the XLA fused path end to end on TPC-H Q1/Q6-class queries
(PERF.md). `interpret=True` runs it on any backend and is for tests only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from adacom import types as _types  # noqa: F401  (jax_enable_x64)
from adacom.ops import bitpack

MAX_GROUPS = 16
MAX_PLANES = 8
MAX_MONO_DEGREE = 3

# scalar-table columns, (n_seg, 32) int64
SC_COUNT, SC_LANES, SC_GMIN, SC_VMIN, SC_LO, SC_HI = 0, 1, 2, 8, 16, 24


def _lane_tile(n_groups_p2: int, n_out: int, n_lanes: int) -> int:
    """Lanes per program: keeps groups * outputs * lanes int64
    accumulators within ~64 registers per thread at 4 warps."""
    t = 4096 // max(1, n_groups_p2 * n_out)
    t = max(32, min(1024, 1 << (t.bit_length() - 1)))
    while n_lanes % t:
        t //= 2
    return t


@functools.lru_cache(maxsize=64)
def _build(n_seg, n_lanes, gws, vws, n_groups, strides, monos, preds,
           interpret):
    g_p2 = 1 << (n_groups - 1).bit_length()
    n_out = len(monos) + 1
    tile = _lane_tile(g_p2, n_out, n_lanes)
    n_tiles = n_lanes // tile
    widths = tuple(gws) + tuple(vws)
    n_g = len(gws)
    val_planes = sorted({p for m in monos for p in m} | set(preds))
    z = np.int32(0)

    live = [i for i, w in enumerate(widths) if w]

    def kernel(scal_ref, *refs):
        plane_refs = dict(zip(live, refs[:len(live)]))
        out_refs = refs[len(live):]
        t = pl.program_id(1)
        lane = t * tile + jax.lax.broadcasted_iota(jnp.int32, (tile,), 0)
        count = scal_ref[SC_COUNT].astype(jnp.int32)
        l_orig = scal_ref[SC_LANES].astype(jnp.int32)
        in_seg = lane < l_orig
        gids = jax.lax.broadcasted_iota(jnp.int32, (g_p2, 1), 0)
        words = {}

        def code(i, r):
            w = widths[i]
            if w == 0:
                return jnp.zeros((tile,), jnp.uint32)
            p = r * w
            k, off = p >> 5, p & 31
            for kk in (k, k + 1):
                if kk < w and (i, kk) not in words:
                    words[(i, kk)] = plane_refs[i][kk, :]
            c = words[(i, k)]
            if off:
                c = c >> np.uint32(off)
            if off + w > 32:
                c = c | (words[(i, k + 1)] << np.uint32(32 - off))
            if w < 32:
                c = c & np.uint32((1 << w) - 1)
            return c

        accs = [jnp.zeros((g_p2, tile), jnp.int64) for _ in range(n_out)]
        zero = jnp.zeros((g_p2, tile), jnp.int64)
        for r in range(bitpack.ROWS):
            keep = in_seg & (r * l_orig + lane < count)
            vals = {}
            for p in val_planes:
                vals[p] = (code(n_g + p, r).astype(jnp.int64)
                           + scal_ref[SC_VMIN + p])
            for q, p in enumerate(preds):
                keep = keep & (vals[p] >= scal_ref[SC_LO + q]) \
                    & (vals[p] <= scal_ref[SC_HI + q])
            grp = jnp.zeros((tile,), jnp.int32)
            for j in range(n_g):
                g = code(j, r).astype(jnp.int32) \
                    + scal_ref[SC_GMIN + j].astype(jnp.int32)
                grp = grp + g * np.int32(strides[j])
            hot = (grp[None, :] == gids) & keep[None, :]
            for mi, mono in enumerate(monos):
                term = vals[mono[0]]
                for p in mono[1:]:
                    term = term * vals[p]
                accs[mi] = accs[mi] + jnp.where(hot, term[None, :], zero)
            accs[-1] = accs[-1] + hot.astype(jnp.int64)
        for o, a in zip(out_refs, accs):
            o[...] = jnp.sum(a, axis=1)

    in_specs = [pl.BlockSpec((None, 32), lambda s, t: (s, z))]
    for w in widths:
        if w:
            in_specs.append(pl.BlockSpec((None, w, tile),
                                         lambda s, t: (s, z, t)))
    out_spec = pl.BlockSpec((None, None, g_p2), lambda s, t: (s, t, z))
    call = pl.pallas_call(
        kernel,
        grid=(n_seg, n_tiles),
        in_specs=in_specs,
        out_specs=[out_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n_seg, n_tiles, g_p2), jnp.int64)
                   ] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="multi_agg_scan",
    )

    @jax.jit
    def run(scal, *planes):
        outs = call(scal, *planes)
        return jnp.stack([o.sum(axis=(0, 1))[:n_groups] for o in outs],
                         axis=1)

    return run


def multi_scan(gstacks, vstacks, scal, n_groups, strides, monos, preds,
               interpret=False):
    """Per-group monomial sums and match count over stacked packed planes.

    gstacks/vstacks: (n_seg, w, n_lanes) uint32 word stacks, None for a
    zero-width plane; scal: (n_seg, 32) int64 scalar table (SC_* columns);
    monos: tuples of value-plane indices; preds: value-plane indices whose
    [SC_LO + q, SC_HI + q] range must hold. Returns a device array
    (n_groups, len(monos) + 1) int64: monomial sums, then the count."""
    stacks = [s for s in list(gstacks) + list(vstacks) if s is not None]
    n_seg, n_lanes = int(scal.shape[0]), int(stacks[0].shape[2])
    gws = tuple(0 if s is None else int(s.shape[1]) for s in gstacks)
    vws = tuple(0 if s is None else int(s.shape[1]) for s in vstacks)
    run = _build(n_seg, n_lanes, gws, vws, int(n_groups), tuple(strides),
                 tuple(tuple(m) for m in monos), tuple(preds), interpret)
    return run(scal, *stacks)
