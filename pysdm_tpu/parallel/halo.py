"""Halo exchange for sharded Eulerian fields.

The reference is single-device (SURVEY.md §2.5); this is the layer
that replaces its absent distributed backend: under ``shard_map`` over an
``(x,)`` device mesh, each shard owns a contiguous x-slab of the domain and
the MPDATA stencil pads are neighbour exchanges over the device ring
(``lax.ppermute``) instead of local wrap/edge pads. The global domain is
periodic in x, so shard 0 and shard P-1 are ring neighbours — exactly one
bidirectional ppermute per pad."""

import jax
import jax.numpy as jnp
from jax import lax


def ring_halo_pad(arr, axis, axis_name, depth=1):
    """halo-``depth`` pad along `axis` with the neighbouring shards' boundary
    slices (global-periodic ring; one bidirectional ppermute regardless of
    depth). Equivalent single-device semantics: jnp.pad wrap.
    Requires depth <= local extent (always true for the >=2-cell slabs the
    decomposition produces)."""
    n_shards = lax.psum(1, axis_name)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    n = arr.shape[axis]
    last = lax.slice_in_dim(arr, n - depth, n, axis=axis)
    first = lax.slice_in_dim(arr, 0, depth, axis=axis)
    # my left halo = left neighbour's last slices (sent forward)
    left_halo = lax.ppermute(last, axis_name, perm=fwd)
    right_halo = lax.ppermute(first, axis_name, perm=bwd)
    return jnp.concatenate([left_halo, arr, right_halo], axis=axis)


def make_sharded_bc(axis_name):
    """MPDATA boundary-condition entry: per-axis pad via ring halo exchange"""
    return ("shard", axis_name)
