"""Shard-count invariance: the x-slab-decomposed 2D
kinematic case with collisions disabled is deterministic, so the global
state after >=10 steps must agree between n_shards in {1, 2, 4, 8} on the
emulated CPU mesh (f64) to tight tolerance — halo exchange, advector
slicing, migration and the per-slab condensation segments all verified
against the single-shard truth (pysdm_tpu/parallel/verification.py)."""

import numpy as np
import pytest

from pysdm_tpu.parallel.verification import shard_invariance_report
from pysdm_tpu.physics import Formulae, si


def _settings_factory():
    from pysdm_tpu.models.arabas_et_al_2015 import Settings

    return Settings(
        Formulae(seed=21),
        grid=(8, 8),
        size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=16,
    )


def test_shard_count_invariance():
    report = shard_invariance_report(
        _settings_factory, shard_counts=(1, 2, 4, 8), steps=12
    )
    for key, val in report.items():
        if key.startswith("position_max_abs"):
            # grid units; observed ~3e-5 from reassociation amplification
            assert val < 1e-3, f"{key} = {val:.3e}"
        elif key.startswith("water_mass_max_abs"):
            # kg; observed ~2e-16 (drop masses are 1e-18..1e-9)
            assert val < 1e-13, f"{key} = {val:.3e}"
        else:  # env fields, relative
            assert val < 1e-6, f"{key} = {val:.3e}"


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (2, 2)])
def test_2d_tile_invariance(mesh_shape):
    """2D (x, z) TILE decomposition (SURVEY §7 delta 8): same deterministic
    physics as a single device — two-axis halo exchange, two-phase (x then
    z) ring migration with diagonal movers, per-tile advector/g-factor
    slicing and z-offset precipitation/out-of-column semantics all verified
    allclose against the 1-shard truth"""
    import numpy as np
    from pysdm_tpu.parallel.distributed_2d import DistributedSimulation2D
    from pysdm_tpu.parallel.verification import (
        canonical_particles,
        _global_field,
    )

    def factory():
        from pysdm_tpu.models.arabas_et_al_2015 import Settings

        s = Settings(
            Formulae(seed=21), grid=(8, 8),
            size=(1500 * si.m, 1500 * si.m),
            dt=5 * si.s, n_sd_per_gridbox=16,
        )
        s.condensation_adaptive = False
        return s

    results = []
    for shape in ((1, 1), mesh_shape):
        settings = factory()
        sim = DistributedSimulation2D(settings, mesh_shape=shape)
        sim.particulator.set_flag("collision_enable", False)
        sim.run(8)
        sim.particulator.block_until_ready()
        results.append(
            (
                canonical_particles(sim, settings),
                {f: _global_field(sim, settings, f) for f in ("thd", "qv")},
            )
        )
    (r0, f0), (r1, f1) = results
    assert r1.shape == r0.shape
    np.testing.assert_array_equal(r1[:, 0], r0[:, 0])
    np.testing.assert_array_equal(r1[:, 4], r0[:, 4])
    assert np.max(np.abs(r1[:, 1:3] - r0[:, 1:3])) < 1e-3
    assert np.max(np.abs(r1[:, 3] - r0[:, 3])) < 1e-13
    for f in f0:
        assert np.max(np.abs(f1[f] - f0[f]) / np.abs(f0[f])) < 1e-6


def test_2d_tile_full_physics_runs():
    """tile decomposition with stochastic collisions enabled: compiles,
    runs, conserves the global water budget, keeps condensation clean"""
    import numpy as np
    from pysdm_tpu.models.arabas_et_al_2015 import Settings
    from pysdm_tpu.parallel.distributed_2d import DistributedSimulation2D

    settings = Settings(
        Formulae(seed=9), grid=(8, 8), size=(1500 * si.m, 1500 * si.m),
        dt=5 * si.s, n_sd_per_gridbox=16,
    )
    sim = DistributedSimulation2D(settings, mesh_shape=(2, 4))
    d0 = sim.global_diagnostics()
    sim.run(6)
    d1 = sim.global_diagnostics()
    assert d1["condensation_ok"] == 1.0
    np.testing.assert_allclose(
        d1["water_total"], d0["water_total"], rtol=1e-9
    )
    assert d1["migration_dropped"] == 0.0
