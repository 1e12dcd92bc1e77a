"""Per-drop reads of per-cell tables are plain indexed gathers: bitwise
equal to NumPy indexing (with the index clamps the callers rely on) on
both sides of any table size, and no step on the main path compiles a
matrix product."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pysdm_tpu.dynamics.terminal_velocity import _gk_table, gunn_kinzer_v_term
from pysdm_tpu.impl.attributes import _env_at_drops
from pysdm_tpu.ops.condensation import _cell_rows_to_drops
from pysdm_tpu.ops.displacement import courant_at_particles, face_strides
from pysdm_tpu.physics import Formulae

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

N_CELLS = (1, 625, 10000)
N_DROPS = 5000


def _cell_ids(n_cell, rng):
    """ids spanning the table, plus out-of-range ones a dead drop may carry"""
    ids = rng.integers(0, n_cell, N_DROPS)
    ids[:4] = (-3, n_cell, n_cell + 7, 0)
    return ids


@pytest.mark.parametrize("n_cell", N_CELLS)
def test_env_row_gather(n_cell):
    rng = np.random.default_rng(n_cell)
    row = rng.uniform(250, 300, n_cell)
    ids = _cell_ids(n_cell, rng)
    got = np.asarray(_env_at_drops(jnp.asarray(row), jnp.asarray(ids, jnp.int32)))
    np.testing.assert_array_equal(got, row[np.clip(ids, 0, n_cell - 1)])


@pytest.mark.parametrize("n_cell", N_CELLS)
def test_condensation_cell_rows_gather(n_cell):
    rng = np.random.default_rng(n_cell + 1)
    pack = rng.uniform(0, 1, (n_cell, 7))
    ids = _cell_ids(n_cell, rng)
    got = np.asarray(
        _cell_rows_to_drops(jnp.asarray(pack), jnp.asarray(ids, jnp.int32), n_cell)
    )
    np.testing.assert_array_equal(got, pack[np.clip(ids, 0, n_cell - 1)])


@pytest.mark.parametrize("grid", ((1, 1), (25, 25), (100, 100)))
def test_courant_face_gather(grid):
    rng = np.random.default_rng(sum(grid))
    for d in range(2):
        face_shape = tuple(g + (i == d) for i, g in enumerate(grid))
        courant = rng.uniform(-1, 1, face_shape)
        strides = face_strides(grid, d)
        origin = np.stack([rng.integers(0, g, N_DROPS) for g in grid])
        origin[:, 0] = (-1, 0)  # a dead particle's garbage origin
        origin[:, 1] = (grid[0] + 2, grid[1])
        c_l, c_r = courant_at_particles(
            jnp.asarray(courant), strides, jnp.asarray(origin, jnp.int32), d
        )
        flat = courant.ravel()
        base = np.clip((strides[:, None] * origin).sum(axis=0), 0, flat.size - 1)
        np.testing.assert_array_equal(np.asarray(c_l), flat[base])
        np.testing.assert_array_equal(
            np.asarray(c_r), flat[np.minimum(base + strides[d], flat.size - 1)]
        )


@pytest.mark.parametrize("n_drops", N_CELLS)
def test_terminal_velocity_table_gather(n_drops):
    rng = np.random.default_rng(n_drops)
    radius = np.exp(rng.uniform(np.log(1e-7), np.log(1e-2), n_drops))
    radius[0] = -1e-6 if n_drops > 1 else radius[0]
    got = np.asarray(
        gunn_kinzer_v_term(Formulae().constants, jnp.asarray(radius))
    )
    a, b = (np.asarray(t, np.float32) for t in _gk_table())
    scaled = np.clip(radius, 0.0, 0.6e-2) * 100000
    idx = np.clip(scaled.astype(np.int32), 0, a.size - 1)
    want = a[idx].astype(np.float64) + (scaled - idx) / 100000 * b[idx].astype(
        np.float64
    )
    want = np.where(radius < 0, 0.0, want)
    np.testing.assert_array_equal(got, want)


def _box():
    import bench

    return bench.build_box(2**8)


def _parcel():
    import bench

    return bench.build_parcel(2**6)


def _column():
    from pysdm_tpu.models.shipway_and_hill_2012 import Settings, Simulation

    settings = Settings(
        n_sd_per_gridbox=4, dt=30.0, dz=300.0, z_max=1200.0, precip=True,
        seed=44,
    )
    return Simulation(settings).particulator


def _warm_rain():
    import bench

    return bench.build_warm_rain(grid=(8, 8), n_sd_per_gridbox=4)[0]


@pytest.mark.parametrize(
    "build", (_box, _parcel, _column, _warm_rain),
    ids=("box", "parcel", "column_1d", "warm_rain"),
)
def test_step_has_no_matrix_product(build):
    particulator = build()
    text = particulator._step_fn.lower(particulator.sim_state).as_text()
    assert "dot_general" not in text
    assert "gather" in text or particulator.mesh.n_cell == 1
