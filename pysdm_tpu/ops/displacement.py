"""Vectorized particle displacement ops (advection by flow + sedimentation).

Semantics parity with reference
``PySDM/backends/impl_numba/methods/displacement_methods.py``: per-particle
Arakawa-C courant interpolation (implicit- or explicit-in-space scheme),
precipitation flagging on bottom-boundary crossing, out-of-column flagging.
All gathers are flat-index vector gathers over the face arrays; the
reference's idx-compaction removal becomes multiplicity-zero masking.
"""

import jax.numpy as jnp
import numpy as np


def face_strides(grid, d):
    """row-major strides of the d-face array (grid with +1 along axis d)"""
    shape = list(grid)
    shape[d] += 1
    strides = np.ones(len(grid), dtype=np.int64)
    for ax in range(len(grid) - 2, -1, -1):
        strides[ax] = strides[ax + 1] * shape[ax + 1]
    return strides


def courant_at_particles(courant_d, strides_d, cell_origin, d):
    """(c_left, c_right) of each particle's cell along axis d
    (reference ``calculate_displacement_body_1d/2d/3d``). Both indices are
    clamped into the flat face table: a dead particle's garbage origin
    must not read out of range."""
    base = jnp.sum(
        jnp.asarray(strides_d)[:, None] * cell_origin, axis=0
    )
    flat = courant_d.reshape(-1)
    last = flat.shape[0] - 1
    left = jnp.clip(base, 0, last).astype(jnp.int32)
    right = jnp.minimum(left + int(strides_d[d]), last)
    return flat[left], flat[right]


def calculate_displacement(
    formulae, courant, courant_strides, cell_origin, position_in_cell, n_substeps
):
    """in-cell displacement (grid units) for every dim; courant fields are
    divided by n_substeps (reference ``calculate_displacement_body_common``)"""
    disp = []
    for d, courant_d in enumerate(courant):
        c_l, c_r = courant_at_particles(
            courant_d, courant_strides[d], cell_origin, d
        )
        disp.append(
            formulae.particle_advection.displacement(
                position_in_cell[d], c_l / n_substeps, c_r / n_substeps
            )
        )
    return jnp.stack(disp)


def flag_precipitated(
    *, cell_origin, position_in_cell, displacement, multiplicity, water_mass,
    precipitation_counting_level_index, z_offset=0,
):
    """mass flux through the bottom counting level; flagged particles die
    (reference ``_flag_precipitated_body``). ``z_offset`` shifts local z
    origins into GLOBAL column coordinates on a z-decomposed mesh (the
    counting level is a global index). Returns (rainfall_mass, new_mult)."""
    z_abs = z_offset + cell_origin[-1] + position_in_cell[-1]
    flagged = (
        (displacement[-1] < 0)
        & (z_abs < precipitation_counting_level_index)
        & (multiplicity > 0)
    )
    rainfall_mass = jnp.sum(
        jnp.where(flagged, jnp.abs(water_mass) * multiplicity.astype(water_mass.dtype), 0.0)
    )
    return rainfall_mass, jnp.where(flagged, 0, multiplicity)


def flag_out_of_column(
    *, cell_origin, position_in_cell, multiplicity, domain_top_level_index,
    z_offset=0,
):
    """particles leaving the column vertically die (reference
    ``_flag_out_of_column_body``); ``domain_top_level_index`` and
    ``z_offset`` are in GLOBAL column coordinates on a z-decomposed mesh"""
    z_abs = z_offset + cell_origin[-1] + position_in_cell[-1]
    out = (z_abs < 0) | (z_abs > domain_top_level_index)
    return jnp.where(out, 0, multiplicity)


def update_cell_origin(cell_origin, position_in_cell):
    """integer-part carry from position to origin"""
    floor = jnp.floor(position_in_cell)
    return (
        cell_origin + floor.astype(cell_origin.dtype),
        position_in_cell - floor,
    )


def periodic_boundary(cell_origin, grid):
    return cell_origin % jnp.asarray(grid, dtype=cell_origin.dtype)[:, None]


def recalculate_cell_id(cell_origin, strides):
    return jnp.sum(
        jnp.asarray(strides).reshape(-1, 1) * cell_origin, axis=0
    ).astype(jnp.int32)
