"""Golden-trace parity tests: committed expected state trajectories for
multi-cell coalescence, breakup and time-dependent freezing under injected
u01 streams, hand-derived step by step from the reference algorithms
(``collisions_methods.py:45-59,136-243,522-560``,
``freezing_methods.py:79-111``). Unlike the single-cell hand cases in
``test_u01_injection.py``, these protect the multi-cell segment logic:
per-cell normalization, in-cell pairing after the bucket shuffle, and
per-cell counter accumulation."""

import numpy as np
import pytest

from pysdm_tpu import Builder, Formulae
from pysdm_tpu.backends import CPU
from pysdm_tpu.dynamics import Breakup, Coalescence, Freezing
from pysdm_tpu.dynamics.collisions.breakup_fragmentations import AlwaysN
from pysdm_tpu.dynamics.collisions.collision_kernels import ConstantK
from pysdm_tpu.environments import Box
from pysdm_tpu.impl.mesh import Mesh
from pysdm_tpu.physics import si

RHO_W = 1000.0


class TestMultiCellCoalescenceGolden:
    """3 cells x 4 super-droplets, ConstantK(a=1), dv=1 per cell, dt=1.

    Derivation (reference ``compute_gamma`` + ``coalesce``): per cell the
    Shima eq. 20 norm = dt/dv * 4*3/2 / 2 = 3; ascending shuffle keys keep
    in-cell order, so pairs are (slot0,slot1), (slot2,slot3); rand=0.999999
    makes gamma_f = prob (integer); gamma = min(gamma_f, floor(xi_j/xi_k)).

    cell 0 [16,8,4,2]: (16,8): gamma=min(48,2)=2 -> xi_j=0 -> split -> (4,4),
      both volumes 1e-12+2*1e-12=3e-12; (4,2): gamma=min(12,2)=2 -> split ->
      (1,1), volumes 3e-12.
    cell 1 [10,10,3,1]: (10,10): tie -> j=leader, gamma=min(30,1)=1 ->
      split -> (5,5), volumes 2e-12; (3,1): gamma=min(9,3)=3 -> xi_j=0 ->
      split of mk=1: half_floor(1)=0 -> (0,1), volumes 4e-12.
    cell 2 [7,5,2,2]: (7,5): gamma=min(21,1)=1 -> xi_j=2 (no split): j keeps
      1e-12, k=5 @ 2e-12; (2,2): gamma=min(6,1)=1 -> split -> (1,1) @ 2e-12.
    """

    N_CELL = 3
    MULT0 = np.asarray([16, 8, 4, 2, 10, 10, 3, 1, 7, 5, 2, 2])
    EXPECTED_MULT = np.asarray([4, 4, 1, 1, 5, 5, 0, 1, 2, 5, 1, 1])
    EXPECTED_VOL = (
        np.asarray([3, 3, 3, 3, 2, 2, 4, 4, 1, 2, 2, 2]) * 1e-12
    )

    def build(self):
        n_sd = 12
        formulae = Formulae(seed=7)
        builder = Builder(
            n_sd=n_sd, backend=CPU(formulae),
            environment=Box(dt=1 * si.s, dv=1 * si.m**3),
        )
        builder.particulator.mesh = Mesh(
            (self.N_CELL,), (float(self.N_CELL),)
        )
        builder.enable_u01_injection()
        builder.add_dynamic(
            Coalescence(collision_kernel=ConstantK(a=1.0), adaptive=False)
        )
        attributes = {
            "multiplicity": self.MULT0.astype(np.int64),
            "volume": np.full(n_sd, 1e-12),
            "cell id": np.repeat(np.arange(self.N_CELL, dtype=np.int64), 4),
        }
        return builder.build(attributes)

    def test_one_step_matches_committed_trace(self):
        p = self.build()
        n_sd = 12
        p.inject_u01(
            {
                "collision_shuffle": np.linspace(0.05, 0.95, n_sd),
                "collision_gamma": np.full(n_sd, 0.999999),
                "collision_process": np.zeros(n_sd),
                "collision_fragmentation": np.zeros(n_sd),
            }
        )
        p.run(1)
        p.block_until_ready()
        particles = p.sim_state["particles"]
        cell = np.asarray(particles.cell_id)
        mult = np.asarray(p.attributes["multiplicity"])
        vol = np.asarray(p.attributes["volume"])
        # state is cell-major in sorted order; in-cell order preserved by
        # the ascending injected keys
        np.testing.assert_array_equal(
            cell, np.repeat(np.arange(self.N_CELL), 4)
        )
        np.testing.assert_array_equal(mult, self.EXPECTED_MULT)
        np.testing.assert_allclose(vol, self.EXPECTED_VOL, rtol=1e-6)
        # per-cell rate counters (reference atomic counters ->
        # deterministic segment sums): sum of gamma * xi_k per cell
        rate = np.asarray(p.get_counter("coalescence_rate"))
        #   cell0: 2*8 + 2*2 = 20; cell1: 1*10 + 3*1 = 13; cell2: 1*5+1*2 = 7
        np.testing.assert_array_equal(rate, [20, 13, 7])

    def test_mass_and_rates_after_two_steps(self):
        """second step from the committed post-step-1 state, same streams —
        total water per cell is invariant across the whole trajectory"""
        p = self.build()
        n_sd = 12
        streams = {
            "collision_shuffle": np.linspace(0.05, 0.95, n_sd),
            "collision_gamma": np.full(n_sd, 0.999999),
            "collision_process": np.zeros(n_sd),
            "collision_fragmentation": np.zeros(n_sd),
        }
        for _ in range(2):
            p.inject_u01(streams)
            p.run(1)
        p.block_until_ready()
        particles = p.sim_state["particles"]
        cell = np.asarray(particles.cell_id)
        mult = np.asarray(p.attributes["multiplicity"], dtype=float)
        mass = np.asarray(p.attributes["water mass"])
        cell_mass = np.asarray(
            [np.sum((mult * mass)[cell == c]) for c in range(self.N_CELL)]
        )
        mass0 = 1e-12 * RHO_W
        expected = np.asarray([30.0, 24.0, 16.0]) * mass0
        np.testing.assert_allclose(cell_mass, expected, rtol=1e-6)


class TestBreakupGolden:
    """one pair [4 @ 2e-12 m^3, 2 @ 1e-12 m^3], ConstantK(1), AlwaysN(n=2).

    Derivation (reference ``break_up``/``compute_transfer_multiplicities``):
    norm = 1 (n=2); prob = 4; rand=0.5 -> gamma_f = 4 capped at
    floor(4/2) = 2. Ec=0, Eb=1 -> always breakup. fragment mass =
    (2+1)e-9/2 = 1.5e-9; alpha = 2, beta = 4/3:
      g=1: new_mult_k = 2*2 = 4, take_from_j = 2 (valid);
      g=2: take_from_j = 6 > xi_j = 4 (invalid) -> gamma_j_k = 1.
    Update: xi_j = 4-2 = 2 keeps mass 2e-9; xi_k = 4 fragments of
    (1e-9*2 + 2*2e-9)/4 = 1.5e-9. Rate = 1*2 = 2; deficit = (2-1)*2 = 2.
    """

    def test_single_breakup_event(self):
        formulae = Formulae(seed=7)
        builder = Builder(
            n_sd=2, backend=CPU(formulae),
            environment=Box(dt=1 * si.s, dv=1 * si.m**3),
        )
        builder.enable_u01_injection()
        builder.add_dynamic(
            Breakup(
                collision_kernel=ConstantK(a=1.0),
                fragmentation_function=AlwaysN(n=2),
                adaptive=False,
            )
        )
        p = builder.build(
            {
                "multiplicity": np.asarray([4, 2], dtype=np.int64),
                "volume": np.asarray([2e-12, 1e-12]),
            }
        )
        p.inject_u01(
            {
                "collision_shuffle": np.asarray([0.1, 0.9]),
                "collision_gamma": np.asarray([0.5, 0.5]),
                "collision_process": np.asarray([0.5, 0.5]),
                "collision_fragmentation": np.asarray([0.5, 0.5]),
            }
        )
        p.run(1)
        p.block_until_ready()
        mult = np.asarray(p.attributes["multiplicity"])
        mass = np.asarray(p.attributes["water mass"])
        np.testing.assert_array_equal(mult, [2, 4])
        np.testing.assert_allclose(mass, [2e-9, 1.5e-9], rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(p.get_counter("breakup_rate")), [2.0]
        )
        np.testing.assert_allclose(
            np.asarray(p.get_counter("breakup_rate_deficit")), [2.0]
        )
        # mass conserved: 4*2 + 2*1 = 2*2 + 4*1.5 (in 1e-9 kg)
        np.testing.assert_allclose(
            float((mult * mass).sum()), 10e-9, rtol=1e-9
        )


class TestTimeDependentFreezingGolden:
    """3 cells, constant J_het = 1e5 1/m^2/s, insoluble areas 1e-5 m^2,
    dt=1 -> freezing probability per step p = 1 - exp(-1) = 0.63212...
    (reference ``freezing_methods.py:79-111`` Poisson sampling).

    Committed expectations: a particle freezes iff its injected u01 < p
    AND its cell is water-supersaturated AND it has insoluble area.
    """

    def test_frozen_mask_matches_committed_trace(self):
        n_sd = 6
        formulae = Formulae(
            seed=7,
            particle_shape_and_density="MixedPhaseSpheres",
            heterogeneous_ice_nucleation_rate="Constant",
            constants={"J_HET": 1e5},
        )
        env = Box(dt=1 * si.s, dv=1 * si.m**3)
        builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
        builder.particulator.mesh = Mesh((3,), (3.0,))
        builder.enable_u01_injection()
        builder.add_dynamic(
            Freezing(singular=False, immersion_freezing=True)
        )
        env["T"] = np.full(3, 250.0)
        env["RH"] = np.asarray([1.05, 0.90, 1.05])  # cell 1 subsaturated
        areas = np.asarray([1e-5, 1e-5, 1e-5, 1e-5, 0.0, 1e-5])
        p = builder.build(
            {
                "multiplicity": np.ones(n_sd, dtype=np.int64),
                "water mass": np.full(n_sd, 1e-12),
                "immersed surface area": areas,
                "cell id": np.repeat(np.arange(3, dtype=np.int64), 2),
            }
        )
        p_freeze = 1.0 - np.exp(-1.0)  # J * A * dt = 1
        rand = np.asarray([0.50, 0.70, 0.10, 0.10, 0.10, 0.64])
        p.inject_u01({"freezing_immersion": rand})
        p.run(1)
        p.block_until_ready()
        frozen = np.asarray(p.attributes["signed water mass"]) < 0
        expected = np.asarray([
            True,    # cell 0, rand 0.50 < 0.632
            False,   # cell 0, rand 0.70 > 0.632
            False,   # cell 1 subsaturated
            False,   # cell 1 subsaturated
            False,   # cell 2 but no insoluble area
            False,   # cell 2, rand 0.64 > 0.632 (knife-edge above p)
        ])
        assert 0.63 < p_freeze < 0.633
        np.testing.assert_array_equal(frozen, expected)
        # mass magnitude unchanged by the phase flip
        np.testing.assert_allclose(
            np.abs(np.asarray(p.attributes["signed water mass"])), 1e-12
        )


class TestCondensationGolden:
    """2 cells (one supersaturated RH=1.0051, one subsaturated RH=0.9697)
    x 3 drops, fixed 2 substeps, dt=1, no external forcing (pred == current).

    The expected trajectory is derived by an INDEPENDENT re-implementation
    of the reference trapezoidal scheme (``condensation_methods.py``
    ``step_impl`` 256-356): scalar numpy + scipy.brentq per-drop implicit
    solves (vs the engine's vectorized masked-lockstep bisection), same
    bracket-expansion rule (reference 498-530), same per-cell ml coupling.
    Protects the segment plumbing (cell_start cumsum reductions), the
    cell->drop pack gather, the trapezoidal ordering, and the bisection
    against an algorithmically different root finder. Committed endpoint
    literals additionally freeze the trajectory against drift in BOTH
    implementations."""

    N_CELL = 2
    DT = 1.0
    N_SUB = 2
    R_WET = np.asarray([1e-6, 2e-6, 5e-6, 0.8e-6, 1.5e-6, 4e-6])
    R_DRY = np.asarray([5e-8, 1e-7, 2e-7, 5e-8, 1e-7, 2e-7])
    KAPPA = 0.6
    MULT = np.asarray([2e6, 1e6, 5e5, 2e6, 1e6, 5e5])
    CELL = np.asarray([0, 0, 0, 1, 1, 1], dtype=np.int32)
    CELL_START = np.asarray([0, 3, 6], dtype=np.int32)
    THD0 = np.asarray([297.0, 290.0])
    QV0 = np.asarray([0.0127, 0.0089])
    RHOD = np.asarray([1.1, 1.15])
    # committed endpoints after 3 steps (derived 2026-08-21, f64 CPU)
    EXPECTED_WM = np.asarray([
        2.64020820e-14, 7.40697388e-14, 6.23688091e-13,
        8.03782950e-18, 7.28477385e-17, 6.22981093e-16,
    ])
    EXPECTED_THD = np.asarray([297.00033941, 289.99961926])
    EXPECTED_QV = np.asarray([0.01269988, 0.00890013])

    def setup_method(self):
        import jax.numpy as jnp

        self.f = Formulae(seed=1)
        const = self.f.constants
        self.water_mass0 = 4 / 3 * np.pi * self.R_WET**3 * float(const.rho_w)
        self.vdry = 4 / 3 * np.pi * self.R_DRY**3
        self.m_d = self.RHOD * 1.0
        T0 = np.asarray(self.f.state_variable_triplet.T(self.RHOD, self.THD0))
        self.air_density = self.RHOD * (1 + self.QV0)
        self.air_viscosity = np.asarray(
            self.f.air_dynamic_viscosity.eta_air(T0)
        )
        self.attrs_const = dict(
            vdry=jnp.asarray(self.vdry),
            kappa=jnp.full(6, self.KAPPA),
            f_org=jnp.zeros(6),
            reynolds_number=jnp.full(6, 0.01),
            v_cr=jnp.asarray(4 / 3 * np.pi * (20e-6) ** 3 * np.ones(6)),
        )

    def _thermo(self, thd, qv, rhod):
        f = self.f
        T = np.asarray(f.state_variable_triplet.T(rhod, thd))
        p = np.asarray(f.state_variable_triplet.p(rhod, T, qv))
        pv = np.asarray(f.state_variable_triplet.pv(p, qv))
        lv = np.asarray(f.latent_heat_vapourisation.lv(T))
        pvs = np.asarray(f.saturation_vapour_pressure.pvs_water(T))
        DTp = np.broadcast_to(
            np.asarray(f.diffusion_thermics.D(T, p)), np.shape(T)
        )
        KTp = np.broadcast_to(
            np.asarray(f.diffusion_thermics.K(T, p)), np.shape(T)
        )
        return T, p, pv / pvs, lv, pvs, DTp, KTp

    def _minfun(self, x_new, x_old, dt_sub, kap, forg, rd3, T, RH, Fk, Fd):
        f, const = self.f, self.f.constants
        if x_new > float(f.diffusion_coordinate.x_max()):
            return x_old - x_new
        mass_new = float(f.diffusion_coordinate.mass(x_new))
        v_new = float(f.particle_shape_and_density.mass_to_volume(mass_new))
        r_new = float(f.trivia.radius(v_new))
        sgm = float(
            f.surface_tension.sigma(T, v_new, float(const.PI_4_3) * rd3, forg)
        )
        RH_eq = float(f.hygroscopicity.RH_eq(r_new, T, kap, rd3, sgm))
        r_dr_dt = float(f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd))
        dm_dt = float(
            f.particle_shape_and_density.dm_dt(r=r_new, r_dr_dt=r_dr_dt)
        )
        return x_old - x_new + dt_sub * float(
            f.diffusion_coordinate.dx_dt(mass_new, dm_dt)
        )

    def _independent_step(self, wm, thd, qv):
        """reference ``step_impl`` in scalar numpy + scipy.brentq"""
        from scipy.optimize import brentq

        f, const = self.f, self.f.constants
        cell, mult, rhod = self.CELL, self.MULT, self.RHOD
        wm, thd, qv = wm.copy(), thd.copy(), qv.copy()
        dt_sub = self.DT / self.N_SUB
        ml = np.asarray(
            [np.sum(mult[cell == c] * wm[cell == c]) for c in range(self.N_CELL)]
        )
        for _ in range(self.N_SUB):
            T, p, RH, lv, pvs, DTp, KTp = self._thermo(thd, qv, rhod)
            wm_new = wm.copy()
            for i in range(len(wm)):
                c = cell[i]
                v_drop = float(f.particle_shape_and_density.mass_to_volume(wm[i]))
                x_old = float(f.diffusion_coordinate.x(wm[i]))
                r_old = float(f.trivia.radius(v_drop))
                rd3 = self.vdry[i] / float(const.PI_4_3)
                sgm = float(f.surface_tension.sigma(T[c], v_drop, self.vdry[i], 0.0))
                RH_eq = float(
                    f.hygroscopicity.RH_eq(r_old, T[c], self.KAPPA, rd3, sgm)
                )
                lambdaK = float(f.diffusion_kinetics.lambdaK(T[c], p[c]))
                lambdaD = float(f.diffusion_kinetics.lambdaD(DTp[c], T[c]))
                Dr = float(f.diffusion_kinetics.D(DTp[c], r_old, lambdaD))
                Kr = float(f.diffusion_kinetics.K(KTp[c], r_old, lambdaK))
                Sc = float(f.trivia.air_schmidt_number(
                    dynamic_viscosity=self.air_viscosity[c],
                    diffusivity=DTp[c], density=self.air_density[c],
                ))
                vent = float(f.ventilation.ventilation_coefficient(
                    sqrt_re_times_cbrt_sc=float(
                        f.trivia.sqrt_re_times_cbrt_sc(Re=0.01, Sc=Sc)
                    )
                ))
                Fk = float(f.drop_growth.Fk(T=T[c], K=Kr * vent, lv=lv[c]))
                Fd = float(f.drop_growth.Fd(T=T[c], D=Dr * vent, pvs=pvs[c]))
                if abs(RH[c] - RH_eq) <= 1e-7 * abs(RH[c]):
                    continue
                r_dr_dt_old = float(
                    f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH[c], Fk=Fk, Fd=Fd)
                )
                dm_dt_old = float(f.particle_shape_and_density.dm_dt(
                    r=r_old, r_dr_dt=r_dr_dt_old
                ))
                dx_old = dt_sub * float(
                    f.diffusion_coordinate.dx_dt(wm[i], dm_dt_old)
                )
                if dx_old == 0:
                    continue
                x_insane = float(f.diffusion_coordinate.x(float(
                    f.particle_shape_and_density.volume_to_mass(self.vdry[i] / 100)
                )))
                args = (x_old, dt_sub, self.KAPPA, 0.0, rd3, T[c], RH[c], Fk, Fd)
                a, fa = x_old, self._minfun(x_old, x_old, *args[1:])
                b = max(x_insane, a + dx_old)
                fb = self._minfun(b, *args)
                it = 0
                while fa * fb >= 0 and it < 16:  # reference 498-530
                    b = max(x_insane, a + dx_old * 2.0 ** (it + 1))
                    fb = self._minfun(b, *args)
                    it += 1
                assert fa * fb < 0
                x_new = brentq(
                    lambda x: self._minfun(x, *args), min(a, b), max(a, b),
                    xtol=1e-14, rtol=8.9e-16,
                )
                wm_new[i] = float(f.diffusion_coordinate.mass(x_new))
            ml_new = np.asarray([
                np.sum(mult[cell == c] * wm_new[cell == c])
                for c in range(self.N_CELL)
            ])
            dqv_dt_corr = -(ml_new - ml) / dt_sub / self.m_d
            dthd_dt_corr = np.asarray(f.state_variable_triplet.dthd_dt(
                rhod=rhod, thd=thd, T=T,
                d_water_vapour_mixing_ratio__dt=dqv_dt_corr, lv=lv,
            ))
            thd = thd + dt_sub * dthd_dt_corr
            qv = qv + dt_sub * dqv_dt_corr
            ml, wm = ml_new, wm_new
        return wm, thd, qv

    def test_three_steps_match_independent_solver_and_committed_trace(self):
        import jax.numpy as jnp

        from pysdm_tpu.ops.condensation import make_condensation_solver

        solver = make_condensation_solver(
            self.f, n_cell=self.N_CELL, dt=self.DT, adaptive=False,
        )
        wm_e = jnp.asarray(self.water_mass0)
        thd_e = jnp.asarray(self.THD0)
        qv_e = jnp.asarray(self.QV0)
        wm_i, thd_i, qv_i = (
            self.water_mass0.copy(), self.THD0.copy(), self.QV0.copy()
        )
        for _ in range(3):
            out = solver(
                attrs={**self.attrs_const, "water_mass": wm_e},
                multiplicity=jnp.asarray(self.MULT),
                cell_of_drop=jnp.asarray(self.CELL),
                cell_start=jnp.asarray(self.CELL_START),
                n_substeps=jnp.full(self.N_CELL, self.N_SUB, jnp.int32),
                thd=thd_e, qv=qv_e, rhod=jnp.asarray(self.RHOD),
                pthd=thd_e, pqv=qv_e, prhod=jnp.asarray(self.RHOD),
                m_d=jnp.asarray(self.m_d),
                air_density=jnp.asarray(self.air_density),
                air_viscosity=jnp.asarray(self.air_viscosity),
            )
            wm_e, thd_e, qv_e, _, _, success, _ = out
            assert bool(np.asarray(success).all())
            wm_i, thd_i, qv_i = self._independent_step(wm_i, thd_i, qv_i)
            # step-by-step: bisection(rtol_x=1e-6) vs brentq(exact)
            np.testing.assert_allclose(np.asarray(wm_e), wm_i, rtol=5e-5)
            np.testing.assert_allclose(np.asarray(thd_e), thd_i, atol=1e-7)
            np.testing.assert_allclose(np.asarray(qv_e), qv_i, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(wm_e), self.EXPECTED_WM, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(thd_e), self.EXPECTED_THD, atol=1e-6)
        np.testing.assert_allclose(np.asarray(qv_e), self.EXPECTED_QV, rtol=1e-6)


class TestDisplacementGolden:
    """nz=4 column, non-uniform courant faces [0.1, 0.3, 0.2, 0.4, 0.05],
    implicit-in-space scheme, adaptive substepping (rtol=1e-2).

    Derivation (reference ``displacement_methods.py:28-108`` +
    ``upload_courant_field`` adaptivity): d_max = max|diff(c)| = 0.35 ->
    smallest power-of-two n with (d/n)/(1-d/n) < 1e-2 is n=64; then per
    substep dz = (c_l(1-pos) + c_r pos)/(1 - c_r + c_l) with c/n faces and
    floor-carry cell re-assignment between substeps (drop 0 crosses from
    cell 0 into cell 1 mid-step). Committed endpoints freeze the
    trajectory; an in-test numpy recurrence documents the derivation."""

    COURANT = np.asarray([0.1, 0.3, 0.2, 0.4, 0.05])
    Z0 = np.asarray([0.9, 1.5, 3.75])
    N_SUBSTEPS = 64

    def _independent_trajectory(self):
        c, n = self.COURANT, self.N_SUBSTEPS
        d_max = np.max(np.abs(np.diff(c)))
        n_check = 1.0
        while (d_max / n_check) / (1 - d_max / n_check) >= 1e-2:
            n_check *= 2
        assert int(n_check) == n
        z = self.Z0.copy()
        for _ in range(n):
            cell = np.floor(z).astype(int)
            pos = z - cell
            c_l, c_r = c[cell] / n, c[cell + 1] / n
            z = z + (c_l * (1 - pos) + c_r * pos) / (1 - c_r + c_l)
        return z

    def _build(self, courant, z0, enable_sedimentation=False, dt=1.0):
        from pysdm_tpu.dynamics import Displacement
        from pysdm_tpu.environments import Kinematic1D

        nz = 4
        mesh = Mesh(grid=(nz,), size=(nz * 100.0,))
        env = Kinematic1D(
            dt=dt, mesh=mesh,
            thd_of_z=lambda z: np.full_like(z, 300.0),
            rhod_of_z=lambda z: np.full_like(z, 1.0),
            water_vapour_mixing_ratio_of_z=lambda z: np.full_like(z, 1e-3),
        )
        builder = Builder(
            n_sd=len(z0), backend=CPU(Formulae(seed=3)), environment=env
        )
        builder.add_dynamic(Displacement(
            enable_sedimentation=enable_sedimentation,
            precipitation_counting_level_index=0,
        ))
        cell_id, cell_origin, position_in_cell = mesh.cellular_attributes(
            z0[None, :]
        )
        p = builder.build({
            "multiplicity": np.full(len(z0), 1000.0),
            "volume": np.full(len(z0), 4 / 3 * np.pi * (20e-6) ** 3),
            "cell id": cell_id,
            "cell origin": cell_origin,
            "position in cell": position_in_cell,
        })
        import jax.numpy as jnp

        p.sim_state["env"]["courant_0"] = jnp.asarray(
            courant, dtype=p.dtype
        )
        return p

    def test_nonuniform_advection_matches_committed_trace(self):
        p = self._build(self.COURANT, self.Z0)
        p.run(1)
        z = (
            p.attributes["cell origin"][-1]
            + p.attributes["position in cell"][-1]
        )
        expected = self._independent_trajectory()
        assert int(np.asarray(
            p.get_counter("max_n_substeps_displacement")
        ).max()) >= 1
        np.testing.assert_allclose(z, expected, rtol=1e-12)
        # committed literals (derived 2026-08-21): drop 0 crossed cells
        np.testing.assert_allclose(
            expected, [1.19023997, 1.73772991, 3.86575128], atol=2e-8
        )

    def test_precipitation_exact_accounting(self):
        """uniform downdraft courant -0.3 (n_sub=1): the z=0.2 drop crosses
        the counting level; precipitated mass == mult * water_mass exactly"""
        z0 = np.asarray([0.2, 2.5])
        p = self._build(
            np.full(5, -0.3), z0, enable_sedimentation=True, dt=1.0
        )
        v_fall = np.asarray(p.attributes["relative fall velocity"])
        wm = np.asarray(p.attributes["water mass"])
        p.run(1)
        mult = np.asarray(p.attributes["multiplicity"])
        assert mult[0] == 0 and mult[1] == 1000
        precip = float(p.get_counter("precipitated_mass")[0])
        np.testing.assert_allclose(precip, 1000.0 * wm[0], rtol=1e-12)
        # survivor's trajectory: uniform courant -> dz = c - v_fall*dt/dz
        z1 = (
            p.attributes["cell origin"][-1]
            + p.attributes["position in cell"][-1]
        )[1]
        np.testing.assert_allclose(
            z1, 2.5 - 0.3 - v_fall[1] * 1.0 / 100.0, rtol=1e-12
        )
