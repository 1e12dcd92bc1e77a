"""Multi-chip 2D warm-rain smoke test on the emulated 8-device CPU mesh:
the x-slab-decomposed simulation must run the full physics chain with a
closed global water budget and working particle migration."""

import numpy as np
import pytest

from pysdm_tpu.models.arabas_et_al_2015 import Settings
from pysdm_tpu.parallel import DistributedSimulation2D
from pysdm_tpu.physics import Formulae, si

N_DEV = 8


@pytest.fixture(scope="module")
def dist_sim():
    settings = Settings(
        Formulae(seed=17),
        grid=(16, 8),
        size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=8,
    )
    return settings, DistributedSimulation2D(settings, n_shards=N_DEV)


def total_water(sim):
    p = sim.particulator
    rhod = sim.get_env("rhod")
    vapour = float(np.sum(rhod * sim.get_env("qv") * p.mesh.dv))
    mult = p.attributes["multiplicity"].astype(float)
    liquid = float(np.sum(mult * p.attributes["water mass"]))
    precip = float(np.sum(p.get_counter("precipitated_mass")))
    return vapour + liquid + precip


def test_distributed_step_runs_and_conserves_water(dist_sim):
    settings, sim = dist_sim
    p = sim.particulator
    n_alive0 = int((p.attributes["multiplicity"] > 0).sum())
    w0 = total_water(sim)
    sim.run(24)  # 2 min
    p.block_until_ready()
    assert np.asarray(p.get_counter("condensation_success")).all()
    assert int(np.sum(p.get_counter("migration_dropped"))) == 0
    np.testing.assert_allclose(total_water(sim), w0, rtol=1e-3)
    rh = sim.get_env("RH")
    assert np.isfinite(rh).all() and rh.max() < 1.2
    # particles still tracked (modulo out-of-column deaths)
    n_alive1 = int((p.attributes["multiplicity"] > 0).sum())
    assert n_alive1 > 0.9 * n_alive0


def test_particles_migrate_between_shards(dist_sim):
    settings, sim = dist_sim
    p = sim.particulator
    nxl = settings.grid[0] // N_DEV
    cap = p.particles.n_sd // N_DEV
    shard0 = np.arange(p.particles.n_sd) // cap
    # per-shard alive counts change as the eddy sweeps particles around
    def per_shard_alive():
        alive = np.asarray(p.attributes["multiplicity"]) > 0
        return np.array([alive[shard0 == s].sum() for s in range(N_DEV)])

    before = per_shard_alive()
    sim.run(36)  # 3 more minutes of eddy transport
    p.block_until_ready()
    after = per_shard_alive()
    assert int(np.sum(p.get_counter("migration_dropped"))) == 0
    assert (before != after).any(), "eddy must move particles across slabs"
    # global cell ids remain in range
    gids = sim.global_cell_id()
    alive = np.asarray(p.attributes["multiplicity"]) > 0
    assert gids[alive].min() >= 0
    assert gids[alive].max() < settings.grid[0] * settings.grid[1]


class _CrosswindSettings(Settings):
    """uniform strong horizontal flow (courant_x ~ 0.85): every particle
    streams across the periodic x boundary, sustaining near-capacity
    migration pressure on every shard boundary every step"""

    U_RHOD = 17.5  # kg m^-2 s^-1: u*dt/dx ~ 0.85 at dx=93.75 m, dt=5 s

    def stream_function(self, xX, zZ, _):
        # psi = -u_rhod * Z * zZ  ->  d(psi)/dz = -u_rhod: uniform rhod*u
        return -self.U_RHOD * self.size[1] * zZ


@pytest.fixture(scope="module")
def crosswind_sim():
    settings = _CrosswindSettings(
        Formulae(seed=23),
        grid=(16, 8),
        size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=8,
    )
    return settings, DistributedSimulation2D(settings, n_shards=N_DEV)


def test_migration_under_sustained_crosswind(crosswind_sim):
    """drive particles across slab boundaries for >=50 steps
    near the migration-capacity ceiling; the fixed-capacity ring exchange
    must deliver every mover (no drops, no far moves) and the global water
    budget must stay closed under sustained migration pressure
    (deficit-accounting analogue: reference breakup overflow bookkeeping,
    ``collisions_methods.py:64-93,167-175``)"""
    settings, sim = crosswind_sim
    p = sim.particulator
    cap = p.particles.n_sd // N_DEV
    shard_of_slot = np.arange(p.particles.n_sd) // cap

    def per_shard_alive():
        alive = np.asarray(p.attributes["multiplicity"]) > 0
        return np.array([alive[shard_of_slot == s].sum() for s in range(N_DEV)])

    w0 = total_water(sim)
    n_alive0 = int((np.asarray(p.attributes["multiplicity"]) > 0).sum())
    occupancy = [per_shard_alive()]
    for _ in range(5):
        sim.run(11)  # 55 steps total
        occupancy.append(per_shard_alive())
    p.block_until_ready()

    assert int(np.sum(p.get_counter("migration_dropped"))) == 0
    assert int(np.sum(p.get_counter("migration_far_moves"))) == 0
    np.testing.assert_allclose(total_water(sim), w0, rtol=1e-3)
    # at courant_x ~0.85 over 55 steps each particle crosses slabs ~23
    # times; occupancy must visibly churn yet never exceed the slot budget
    occupancy = np.stack(occupancy)
    assert (occupancy[1:] != occupancy[0]).any(axis=1).all()
    assert occupancy.max() <= cap
    # crosswind only relocates particles: the global alive population must
    # not leak through the exchange (deaths here: precipitation only)
    n_alive1 = int((np.asarray(p.attributes["multiplicity"]) > 0).sum())
    assert n_alive1 >= 0.95 * n_alive0


def test_migration_capacity_overflow_is_counted_not_silent():
    """undersized migration buffers must surface as a positive
    ``migration_dropped`` count (loud deficit accounting), never a hang,
    shape error, or silent mis-delivery"""
    settings = _CrosswindSettings(
        Formulae(seed=29),
        grid=(16, 8),
        size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=8,
    )
    sim = DistributedSimulation2D(
        settings, n_shards=N_DEV, migration_capacity=4
    )
    p = sim.particulator
    sim.run(12)
    p.block_until_ready()
    dropped = int(np.sum(p.get_counter("migration_dropped")))
    assert dropped > 0
    mult = np.asarray(p.attributes["multiplicity"])
    assert np.isfinite(np.asarray(p.attributes["water mass"])).all()
    assert (mult >= 0).all()


def test_overlap_migration_equals_inline_when_deterministic():
    """comm/compute-overlap mode (migrate_ring_start + commit after the
    collision phase) must produce the same deterministic trajectory as the
    inline exchange when collisions are disabled — the overlap changes only
    WHEN in-flight particles become visible (they skip the collision step
    of their transit; with collisions off, nothing observes the window)"""
    from pysdm_tpu.parallel.verification import canonical_particles

    def run(overlap):
        settings = Settings(
            Formulae(seed=5),
            grid=(8, 8),
            size=(1500 * si.m, 1500 * si.m),
            dt=5 * si.s,
            n_sd_per_gridbox=8,
        )
        sim = DistributedSimulation2D(
            settings, n_shards=4, migration_capacity=64,
            migration_overlap=overlap,
        )
        sim.particulator.set_flag("collision_enable", False)
        sim.run(8)
        return canonical_particles(sim, settings)

    rows_a = run(True)
    rows_b = run(False)
    np.testing.assert_array_equal(rows_a[:, 0], rows_b[:, 0])
    np.testing.assert_allclose(rows_a, rows_b, rtol=1e-9, atol=1e-18)
