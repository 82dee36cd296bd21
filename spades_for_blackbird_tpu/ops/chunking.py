"""Fixed-shape device chunking with ONE compile per shape.

Python-level slicing of device arrays (``arr[lo:hi]``) bakes the offset
into the HLO, so every chunk offset becomes a distinct single-op
compile.  The
helpers here slice with a TRACED start index via
``lax.dynamic_slice_in_dim`` inside one jit, so a whole chunk loop
reuses a single compiled slice (and one pad) per array shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("chunk",))
def _dslice(arr, lo, chunk: int):
    return jax.lax.dynamic_slice_in_dim(arr, lo, chunk, axis=0)


def dslice(arr, lo: int, chunk: int):
    """arr[lo:lo+chunk] along axis 0 with a traced offset (one compile
    per (shape, chunk)).  The caller must guarantee lo+chunk <= len."""
    return _dslice(arr, jnp.int32(lo), chunk)


def pad_rows(arr, n_rows: int, fill=0):
    """Pad axis 0 up to ``n_rows`` (one compile per output shape)."""
    pad = n_rows - arr.shape[0]
    if pad <= 0:
        return arr
    width = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
    return jnp.pad(arr, width, constant_values=fill)


def pad_to_multiple(arr, chunk: int, fill=0):
    """Pad axis 0 to a multiple of ``chunk``."""
    n = arr.shape[0]
    target = ((n + chunk - 1) // chunk) * chunk
    return pad_rows(arr, target, fill)
