"""Selection-mask kernels: the device replacement for DuckDB SelectionVectors.

The reference materializes selection vectors of matching row ids
(src/common/types/selection_vector.hpp); dynamic-length outputs don't exist
under XLA's static shapes, so filters produce boolean masks and compaction
is a cumsum-scatter into a same-capacity buffer; only the match *count*
syncs to host (one scalar per materialization)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def compact_traced(mask: jax.Array, arrays):
    """Stable-compact `arrays` (same length as mask) to the front.

    Returns (count, compacted arrays); positions >= count contain the last
    valid row's value (garbage — caller slices by count)."""
    idx = jnp.cumsum(mask) - 1
    count = idx[-1] + 1 if mask.shape[0] else jnp.zeros((), idx.dtype)
    n = mask.shape[0]
    target = jnp.where(mask, idx, n)  # out-of-range drops for non-matches
    outs = []
    for a in arrays:
        out = jnp.zeros_like(a)
        out = out.at[target].set(a, mode="drop")
        outs.append(out)
    return count, outs


@jax.jit
def compact(mask, *arrays):
    return compact_traced(mask, arrays)


def tail_mask(n_pad: int, count) -> jax.Array:
    """Mask of real rows for a padded segment (count is dynamic)."""
    i = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0).squeeze(-1)
    return i < count
