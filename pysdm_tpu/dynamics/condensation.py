"""Condensation dynamic (parity: reference ``PySDM/dynamics/condensation.py``):
implicit-in-size condensational growth with per-cell adaptive substepping.

The reference's host-side dynamic cell schedule (argsort by substep count,
``condensation.py:96-101``) is a thread-load-balancing device with no
numerical effect; under the vectorized solver all cells advance in lockstep,
so no schedule is needed. Failure handling: the reference raises
RuntimeError on any per-cell failure; under jit the success flag is recorded
in the ``condensation_success`` counter (AND-reduced per cell) and checked
host-side via ``Condensation.check_success()`` / products."""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np

from ..ops.condensation import make_condensation_solver

DEFAULTS = namedtuple("_", ("rtol_x", "rtol_thd", "cond_range", "schedule"))(
    rtol_x=1e-6,
    rtol_thd=1e-6,
    cond_range=(1e-4, 1.0),
    schedule="dynamic",
)


class Condensation:
    # requests the cell-sorted invariant from the builder's shared-sort
    # analysis: when the state provably enters this step cell-sorted
    # (post-collision bucket shuffle), the stable sort here is skipped
    wants_cell_sort = True

    def __init__(
        self,
        *,
        rtol_x=DEFAULTS.rtol_x,
        rtol_thd=DEFAULTS.rtol_thd,
        substeps: int = 1,
        adaptive: bool = True,
        dt_cond_range: tuple = DEFAULTS.cond_range,
        schedule: str = DEFAULTS.schedule,
        max_iters: int = 16,
        update_thd: bool = True,
        failure_doubling_cap: int = 64,
    ):
        if adaptive and substeps != 1:
            raise ValueError(
                "if specifying substeps count manually, adaptivity must be disabled"
            )
        self.particulator = None
        self.enable = True
        self.rtol_x = rtol_x
        self.rtol_thd = rtol_thd
        self.substeps = substeps
        self.adaptive = adaptive
        self.dt_cond_range = dt_cond_range
        self.schedule = schedule
        self.max_iters = max_iters
        self.update_thd = update_thd
        # Richardson failure-doubling cap (ops/condensation.py): raise for
        # stiff configs when the device watchdog budget allows
        self.failure_doubling_cap = failure_doubling_cap

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("critical volume")
        builder.request_attribute("kappa")
        builder.request_attribute("dry volume organic fraction")
        builder.request_attribute("Reynolds number")
        n_cell = self.particulator.mesh.n_cell
        init_n = self.substeps if not self.adaptive else 1
        builder.add_counter(
            "condensation_n_substeps", n_cell, jnp.int32, fill=init_n
        )
        builder.add_counter("condensation_success", n_cell, jnp.bool_, fill=True)
        builder.add_counter("condensation_RH_max", n_cell, None, fill=0.0)
        # activation-event rate counters (reference counters n_activating /
        # n_deactivating / n_ripening, condensation_methods.py:19)
        # f64 running totals (see collision.py note on f32 counter drift)
        builder.add_counter(
            "condensation_activating", n_cell, jnp.float64, fill=0.0
        )
        builder.add_counter(
            "condensation_deactivating", n_cell, jnp.float64, fill=0.0
        )
        builder.add_counter(
            "condensation_ripening", n_cell, jnp.float64, fill=0.0
        )

    def check_success(self):
        if not np.asarray(
            self.particulator.sim_state["counters"]["condensation_success"]
        ).all():
            raise RuntimeError("Condensation failed")

    def make_step(self, particulator):
        mesh = particulator.mesh
        n_cell = mesh.n_cell
        formulae = particulator.formulae
        resolver = particulator._resolver
        solver = make_condensation_solver(
            formulae,
            n_cell=n_cell,
            dt=particulator.dt,
            rtol_x=self.rtol_x,
            rtol_thd=self.rtol_thd,
            dt_range=self.dt_cond_range,
            adaptive=self.adaptive,
            max_iters=self.max_iters,
            failure_doubling_cap=self.failure_doubling_cap,
        )
        update_thd = self.update_thd

        from ..environments.impl.moist import recalc_thermo
        from ..ops.segments import sort_state_by_cell

        assume_sorted = getattr(self, "_assume_sorted", False)

        def step(sim):
            particles = sim["particles"]
            env = dict(sim["env"])
            counters = dict(sim["counters"])
            # the solver requires cell-sorted drops (cumsum-based per-cell
            # coupling — no scatters); when the builder's shared-sort
            # analysis proves the state already enters cell-sorted (the
            # previous step's collision shuffle — ONE sort per step total),
            # only the segment starts are recomputed. Dead drops then sit
            # inside the last cell's segment (their reconstructed cell_id
            # clips to n_cell-1) and are masked per-drop by multiplicity in
            # the solver.
            if assume_sorted:
                cell_start = jnp.searchsorted(
                    particles.cell_id.astype(jnp.int32),
                    jnp.arange(n_cell + 1, dtype=jnp.int32),
                    side="left",
                ).astype(jnp.int32)
            else:
                particles, _sorted_cell, cell_start = sort_state_by_cell(
                    particles, n_cell, mesh
                )
            signed_mass = particles.ext("signed water mass")
            attrs = {
                "water_mass": signed_mass,
                "vdry": particles.ext("dry volume"),
                "kappa": resolver.get(particles, "kappa"),
                "f_org": resolver.get(particles, "dry volume organic fraction"),
                "reynolds_number": resolver.get(
                    particles, "Reynolds number", env=env
                ),
                "v_cr": resolver.get(particles, "critical volume", env=env),
            }
            water_mass, pthd, pqv, n_substeps, RH_max, success, events = solver(
                attrs=attrs,
                multiplicity=particles.multiplicity,
                cell_of_drop=particles.cell_id,
                cell_start=cell_start,
                n_substeps=counters["condensation_n_substeps"],
                thd=env["thd"], qv=env["qv"], rhod=env["rhod"],
                pthd=env["pred_thd"], pqv=env["pred_qv"],
                prhod=env["pred_rhod"],
                m_d=env["m_d"],
                air_density=env["air_density"],
                air_viscosity=env["air_viscosity"],
            )
            particles = particles.set_ext("signed water mass", water_mass)
            if update_thd:
                env["pred_thd"] = pthd
            env["pred_qv"] = pqv
            # update_TpRH (reference particulator mediator): predicted T/p/RH
            # recomputed from the post-condensation predicted triplet
            (env["T"], env["p"], env["RH"], env["air_density"],
             env["air_viscosity"]) = recalc_thermo(
                formulae, env["pred_thd"], env["pred_qv"], env["pred_rhod"]
            )
            counters["condensation_n_substeps"] = n_substeps
            counters["condensation_success"] = (
                counters["condensation_success"] & success
            )
            counters["condensation_RH_max"] = jnp.maximum(
                counters["condensation_RH_max"], RH_max
            )
            for key, ev in zip(
                ("condensation_activating", "condensation_deactivating",
                 "condensation_ripening"),
                events,
            ):
                counters[key] = counters[key] + ev
            return {**sim, "particles": particles, "env": env,
                    "counters": counters}

        return step
