"""Derived-attribute computation.

Replaces the reference's timestamped attribute dependency graph
(reference ``PySDM/attributes/impl/derived_attribute.py``): under jit there is
no caching to manage — derived attributes are pure functions of the state and
XLA common-subexpression-eliminates repeated evaluation. The registry maps the
reference's attribute names (``PySDM/attributes/``, ~45 classes) to derivation
functions.
"""

import jax.numpy as jnp

# attribute names stored as extensive rows (conserved sums under coalescence)
EXTENSIVE_NAMES = (
    "signed water mass",
    "water mass",  # alias: stored signed
    "dry volume",
    "dry volume organic",
    "kappa times dry volume",
    "immersed surface area",
    "heat",
    "moles_1H",
    "moles_2H",
    "moles_3H",
    "moles_16O",
    "moles_17O",
    "moles_18O",
    "relative fall momentum",
    # aqueous chemistry mole amounts
    "moles_N_mIII",
    "moles_N_V",
    "moles_S_IV",
    "moles_S_VI",
    "moles_C_IV",
    "moles_O3",
    "moles_H2O2",
)

MAXIMUM_NAMES = (
    "freezing temperature",
    # time-dependent-freezing record of the ambient T at the freezing event
    # (reference ``attributes/ice/freezing_temperature.py``
    # TemperatureOfLastFreezing); NaN while unfrozen. Carried as a maximum
    # row: colliding pairs share a cell so fmax-merge of the recorded cell
    # temperatures is the natural tie-break, and fmax ignores the NaN of an
    # unfrozen partner.
    "temperature of last freezing",
    # previous-step ambient T per particle, backing the "cooling rate"
    # derived attribute (reference ``attributes/ice/cooling_rate.py``
    # keeps the same per-particle prev-T array). Max-merge is exact:
    # colliding pairs are in the same cell, so their prev-T agree.
    "cooling rate prev T",
)


def canonical_ext_name(name):
    return "signed water mass" if name == "water mass" else name


def _env_at_drops(env_row, cell_id):
    """broadcast a per-cell env row to drops (indices clamped into the
    table: dead drops may carry any cell id)"""
    return env_row[jnp.clip(cell_id, 0, env_row.shape[0] - 1)]


class AttributeResolver:
    """computes any requested attribute from a ParticleState + Formulae"""

    def __init__(self, formulae):
        self.formulae = formulae
        self.dt = None  # set by Builder.build (needed for "cooling rate")

    def get(self, state, name, env=None):
        f = self.formulae
        if name in ("multiplicity", "n"):
            return state.multiplicity
        if name == "cell id":
            return state.cell_id
        if name == "cell origin":
            return state.cell_origin
        if name == "position in cell":
            return state.position_in_cell
        if name == "signed water mass":
            return state.ext("signed water mass")
        if name == "water mass":
            return jnp.abs(state.ext("signed water mass"))
        if state.has_ext(name):
            return state.ext(name)
        if name in state.max_names:
            return state.max_attr(name)
        if name == "volume":
            return f.particle_shape_and_density.mass_to_volume(
                state.ext("signed water mass")
            )
        if name == "radius":
            return f.trivia.radius(self.get(state, "volume"))
        if name == "sqrt radius":
            return jnp.sqrt(self.get(state, "radius"))
        if name == "area":
            return f.trivia.area(self.get(state, "radius"))
        if name == "dry radius":
            return f.trivia.radius(state.ext("dry volume"))
        if name == "kappa":
            return state.ext("kappa times dry volume") / state.ext("dry volume")
        if name == "temperature":
            return state.ext("heat") / self.get(state, "water mass")  # heat = c_p m T
        if name == "dry volume organic fraction":
            if state.has_ext("dry volume organic"):
                return state.ext("dry volume organic") / state.ext("dry volume")
            return jnp.zeros_like(state.ext("signed water mass"))
        if name == "Reynolds number":
            # Re = 2 r rho_air |v_rel| / eta_air, from the relative fall
            # velocity and the cell's air density/viscosity (reference
            # ``attributes/physics/reynolds_number.py:8-34`` +
            # ``impl_numba/methods/physics_methods.py`` reynolds_number).
            # The reference registers a zeros DummyAttribute when
            # ventilation == Neglect (the coefficient is then 1 regardless);
            # mirror that, and also fall back to zeros when the env carries
            # no air density/viscosity fields (e.g. plain Box).
            if (
                f.ventilation.variant == "Neglect"
                or env is None
                or "air_density" not in env
            ):
                return jnp.zeros_like(state.ext("signed water mass"))
            return f.particle_shape_and_density.reynolds_number(
                radius=self.get(state, "radius"),
                velocity_wrt_air=self.get(state, "relative fall velocity"),
                dynamic_viscosity=_env_at_drops(
                    env["air_viscosity"], state.cell_id
                ),
                density=_env_at_drops(env["air_density"], state.cell_id),
            )
        if name in (
            "critical volume",
            "critical volume neglecting temperature variations",
        ):
            # kappa-Koehler critical wet volume at the ambient cell temperature
            # (reference ``attributes/physics/critical_volume.py`` +
            # ``physics_methods.py`` _critical_volume_body)
            if env is None:
                raise KeyError("critical volume requires the env (cell T)")
            T = _env_at_drops(env["T"], state.cell_id)
            v_dry = state.ext("dry volume")
            sgm = f.surface_tension.sigma(
                T,
                self.get(state, "volume"),
                v_dry,
                self.get(state, "dry volume organic fraction"),
            )
            r_cr = f.hygroscopicity.r_cr(
                self.get(state, "kappa"), v_dry / f.constants.PI_4_3, T, sgm
            )
            return f.trivia.volume(r_cr)
        if name in (
            "wet to critical volume ratio",
            "wet to critical volume ratio neglecting temperature variations",
        ):
            return self.get(state, "volume") / self.get(
                state, "critical volume", env
            )
        if name == "critical saturation":
            # supersaturation at the critical radius (reference
            # ``attributes/physics/critical_supersaturation.py``)
            if env is None:
                raise KeyError("critical saturation requires the env (cell T)")
            T = _env_at_drops(env["T"], state.cell_id)
            v_dry = state.ext("dry volume")
            rd3 = v_dry / f.constants.PI_4_3
            sgm = f.surface_tension.sigma(
                T, self.get(state, "critical volume", env), v_dry,
                self.get(state, "dry volume organic fraction"),
            )
            kappa = self.get(state, "kappa")
            r_cr = f.hygroscopicity.r_cr(kappa, rd3, T, sgm)
            return f.hygroscopicity.RH_eq(r_cr, T, kappa, rd3, sgm)
        if name == "equilibrium saturation":
            # kappa-Koehler equilibrium saturation at the ambient cell T
            # (reference ``attributes/physics/equilibrium_saturation.py``)
            if env is None:
                raise KeyError("equilibrium saturation requires the env")
            T = _env_at_drops(env["T"], state.cell_id)
            v_dry = state.ext("dry volume")
            v_wet = self.get(state, "volume")
            sgm = f.surface_tension.sigma(
                T, v_wet, v_dry,
                self.get(state, "dry volume organic fraction"),
            )
            return f.hygroscopicity.RH_eq(
                self.get(state, "radius"),
                T,
                self.get(state, "kappa"),
                v_dry / f.constants.PI_4_3,
                sgm,
            )
        if name == "hygroscopicity":  # reference alias for kappa
            return self.get(state, "kappa")
        if name.startswith("delta_"):
            # heavy-to-light isotopic ratio vs the VSMOW reference
            heavy = name[len("delta_"):]
            light = "1H" if heavy.endswith("H") else "16O"
            ratio = state.ext(f"moles_{heavy}") / state.ext(f"moles_{light}")
            return f.trivia.isotopic_ratio_2_delta(
                ratio, getattr(f.constants, f"VSMOW_R_{heavy}")
            )
        if name.startswith("conc_") and name != "conc_H":
            # aqueous concentration = mole amount / droplet (liquid) volume
            return state.ext("moles_" + name[len("conc_"):]) / self.get(
                state, "volume"
            )
        if name == "cooling rate":
            # (T_prev - T_now)/dt, positive while cooling; zero unless the
            # particle changed cell (or the ambient T itself changed) since
            # the previous step (reference ``attributes/ice/cooling_rate.py``
            # recalculate: data = (env_T[cell] - prev_T) / -dt). NaN on the
            # first step, before any prev-T has been recorded — as in the
            # reference (prev_T initialised to NaN).
            if env is None:
                raise KeyError("cooling rate requires the env (cell T)")
            prev_T = state.max_attr("cooling rate prev T")
            return (prev_T - _env_at_drops(env["T"], state.cell_id)) / self.dt
        if name == "moles light water":
            # moles of the light isotopologue (1H2 16O) backed out of the
            # total water mass by subtracting the heavy-isotopologue masses
            # (reference ``attributes/isotopes/moles.py`` MolesLightWater)
            const = f.constants
            M_H2O = 2 * const.M_1H + const.M_16O
            mass = self.get(state, "water mass")
            for heavy, M_heavy in (
                ("2H", const.M_1H + const.M_2H + const.M_16O),
                ("3H", const.M_1H + const.M_3H + const.M_16O),
                ("17O", 2 * const.M_1H + const.M_17O),
                ("18O", 2 * const.M_1H + const.M_18O),
            ):
                if state.has_ext(f"moles_{heavy}"):
                    mass = mass - state.ext(f"moles_{heavy}") * M_heavy
            return mass / M_H2O
        if name == "pH":
            # equilibrium hydrogen-ion concentration from electroneutrality
            # (reference ``attributes/chemistry/acidity.py`` — delegates to
            # the same per-drop log-space bisection the AqueousChemistry
            # dynamic uses)
            from ..dynamics.impl import chemistry_utils as chem
            from ..ops import chemistry as chem_ops

            if env is None:
                raise KeyError("pH requires the env (cell T)")
            alive = state.multiplicity > 0
            volume = self.get(state, "volume")
            safe_vol = jnp.where(alive, volume, jnp.ones_like(volume))
            conc = {
                key: state.ext(f"moles_{key}") / safe_vol
                for key in chem.AQUEOUS_COMPOUNDS
                if len(chem.AQUEOUS_COMPOUNDS[key]) > 1
            }
            eq = {
                k: v.at(env["T"])[state.cell_id]
                for k, v in chem.equilibrium_consts(f).items()
            }
            H = chem_ops.equilibrate_H(
                conc=conc,
                K_drop=eq,
                K_H2O=f.constants.K_H2O,
                H_min=float(f.trivia.pH2H(14.0)),
                H_max=float(f.trivia.pH2H(-1.0)),
            )
            return f.trivia.H2pH(H)
        if name == "conc_H":
            # hydrogen-ion concentration derived from pH (reference
            # ``attributes/chemistry/hydrogen_ion_concentration.py``)
            return f.trivia.pH2H(self.get(state, "pH", env))
        if name in ("terminal velocity", "relative fall velocity"):
            # relative fall velocity equals terminal velocity unless the
            # RelaxedVelocity dynamic maintains a momentum attribute
            if state.has_ext("relative fall momentum"):
                return state.ext("relative fall momentum") / self.get(
                    state, "water mass"
                )
            return self.terminal_velocity(state)
        raise KeyError(f"unknown attribute: {name}")

    def terminal_velocity(self, state):
        radius = self.get(state, "radius")
        f = self.formulae
        variant = f.terminal_velocity.variant
        if variant == "GunnKinzer1949":
            from ..dynamics.terminal_velocity import gunn_kinzer_v_term

            return gunn_kinzer_v_term(f.constants, radius)
        if variant == "PowerSeries":
            from ..dynamics.terminal_velocity import PowerSeries

            return PowerSeries()(radius)
        if hasattr(f.terminal_velocity, "v_term"):
            return f.terminal_velocity.v_term(radius)
        raise NotImplementedError(f"terminal velocity variant {variant}")
