"""Formulae engine: selects one variant per physics family (string-keyed, API
parity with reference ``PySDM/formulae.py``) and binds it to a frozen constants
namespace.

Design delta (SURVEY.md §7.2): instead of the reference's
exec+numba.njit source rewriting and CUDA-C codegen, each formula is a plain
pure function closed over Python-float constants — it traces directly under
``jax.jit`` and constants become compile-time literals. No runtime codegen is
needed; XLA fuses the formula bodies into surrounding kernels.
"""

import os
import time
from types import SimpleNamespace

from .constants import make_constants
from . import (
    diffusion_ice,
    diffusion_kinetics,
    diffusion_thermics,
    drop_growth,
    hygroscopicity,
    ice_nucleation,
    isotopes,
    latent_heat,
    misc_families,
    particle_shape_and_density,
    saturation_vapour_pressure,
    state_variable_triplet,
    surface_tension,
)
from .trivia import Trivia


class Null:
    """placeholder variant for families with no physics selected"""


def _bind(variant_cls, const, variant_name=None):
    """bind a variant class's staticmethods to `const`, returning a namespace"""
    ns = SimpleNamespace()
    for name in dir(variant_cls):
        if name.startswith("_"):
            continue
        fn = getattr(variant_cls, name)
        if callable(fn):
            # close over fn/const by value (default-arg trick not needed in a helper)
            setattr(ns, name, _partial_const(fn, const))
    ns.variant = variant_name or variant_cls.__name__
    return ns


def _partial_const(fn, const):
    def bound(*args, **kwargs):
        return fn(const, *args, **kwargs)

    bound.__name__ = getattr(fn, "__name__", "formula")
    bound.__doc__ = fn.__doc__
    return bound


def _bind_composed(variant_classes, const, variant_name):
    """bind a '+'-composition of variant classes (reference ``formulae.py:336-372``
    ``_pick`` builds ``class Cls(*parent_classes)``): the composed namespace
    carries the union of the parts' formulae; on a method-name collision the
    earliest listed variant wins, matching Python MRO in the reference"""
    ns = SimpleNamespace()
    seen = set()
    for cls in variant_classes:
        for name in dir(cls):
            if name.startswith("_") or name in seen:
                continue
            fn = getattr(cls, name)
            if not callable(fn):
                continue
            seen.add(name)
            setattr(ns, name, _partial_const(fn, const))
    ns.variant = variant_name
    return ns


_NULL_VARIANTS = {"Null": Null}

# family name -> (variants dict, default variant name) — defaults match the
# reference Formulae __init__ signature (reference formulae.py:28-68)
_FAMILIES = {
    "trivia": ({"Trivia": Trivia}, "Trivia"),
    "diffusion_coordinate": (
        misc_families.DIFFUSION_COORDINATE_VARIANTS,
        "WaterMassLogarithm",
    ),
    "saturation_vapour_pressure": (
        saturation_vapour_pressure.VARIANTS,
        "FlatauWalkoCotton",
    ),
    "latent_heat_vapourisation": (latent_heat.VAPOURISATION_VARIANTS, "Kirchhoff"),
    "latent_heat_sublimation": (latent_heat.SUBLIMATION_VARIANTS, "MurphyKoop2005"),
    "hygroscopicity": (hygroscopicity.VARIANTS, "KappaKoehlerLeadingTerms"),
    "drop_growth": (drop_growth.VARIANTS, "Mason1971"),
    "surface_tension": (
        {"Constant": misc_families.SurfaceTensionConstant}
        | surface_tension.VARIANTS,
        "Constant",
    ),
    "diffusion_kinetics": (diffusion_kinetics.VARIANTS, "FuchsSutugin"),
    "diffusion_ice_kinetics": (diffusion_ice.KINETICS_VARIANTS, "Standard"),
    "diffusion_ice_capacity": (diffusion_ice.CAPACITY_VARIANTS, "Spherical"),
    "diffusion_thermics": (diffusion_thermics.VARIANTS, "Neglect"),
    "ventilation": (misc_families.VENTILATION_VARIANTS, "Neglect"),
    "state_variable_triplet": (state_variable_triplet.VARIANTS, "LibcloudphPlusPlus"),
    "particle_advection": (
        misc_families.PARTICLE_ADVECTION_VARIANTS,
        "ImplicitInSpace",
    ),
    "hydrostatics": (
        misc_families.HYDROSTATICS_VARIANTS,
        "ConstantGVapourMixingRatioAndThetaStd",
    ),
    "freezing_temperature_spectrum": (
        _NULL_VARIANTS | ice_nucleation.FREEZING_TEMPERATURE_SPECTRUM_VARIANTS,
        "Null",
    ),
    "heterogeneous_ice_nucleation_rate": (
        _NULL_VARIANTS | ice_nucleation.HETEROGENEOUS_RATE_VARIANTS, "Null"
    ),
    "homogeneous_ice_nucleation_rate": (
        _NULL_VARIANTS | ice_nucleation.HOMOGENEOUS_RATE_VARIANTS, "Null"
    ),
    # fragmentation-number sampling itself lives in
    # dynamics/collisions/breakup_fragmentations.py (+ ops/breakup.py); the
    # physics-family slot accepts the reference's variant names
    # (reference ``PySDM/physics/fragmentation_function/``) for API parity
    "fragmentation_function": (
        _NULL_VARIANTS
        | {
            name: Null
            for name in (
                "AlwaysN", "ConstantMass", "Exponential", "ExponFrag",
                "Feingold1988", "Gaussian", "LowList1982Nf", "SLAMS",
                "Straub2010Nf",
            )
        },
        "AlwaysN",
    ),
    "isotope_equilibrium_fractionation_factors": (
        _NULL_VARIANTS | isotopes.EQUILIBRIUM_VARIANTS, "Null"
    ),
    "isotope_kinetic_fractionation_factors": (
        _NULL_VARIANTS | isotopes.KINETIC_VARIANTS, "Null"
    ),
    "isotope_meteoric_water_line": (
        _NULL_VARIANTS | isotopes.MWL_VARIANTS, "Null"
    ),
    "isotope_ratio_evolution": (
        _NULL_VARIANTS | isotopes.RATIO_EVOLUTION_VARIANTS, "Null"
    ),
    "isotope_diffusivity_ratios": (
        _NULL_VARIANTS | isotopes.DIFFUSIVITY_RATIO_VARIANTS, "Null"
    ),
    "isotope_relaxation_timescale": (
        _NULL_VARIANTS | isotopes.RELAXATION_TIMESCALE_VARIANTS, "Null"
    ),
    "isotope_temperature_inference": (
        _NULL_VARIANTS | isotopes.TEMPERATURE_INFERENCE_VARIANTS, "Null"
    ),
    "isotope_ventilation_ratio": (
        _NULL_VARIANTS | isotopes.VENTILATION_RATIO_VARIANTS, "Neglect"
    ),
    "optical_albedo": (
        _NULL_VARIANTS | misc_families.OPTICAL_ALBEDO_VARIANTS, "Null"
    ),
    "optical_depth": (
        _NULL_VARIANTS | misc_families.OPTICAL_DEPTH_VARIANTS, "Null"
    ),
    "particle_shape_and_density": (
        particle_shape_and_density.VARIANTS,
        "LiquidSpheres",
    ),
    "terminal_velocity": (
        misc_families.TERMINAL_VELOCITY_VARIANTS
        | {"GunnKinzer1949": Null, "PowerSeries": Null},
        "GunnKinzer1949",
    ),
    "air_dynamic_viscosity": (
        misc_families.AIR_DYNAMIC_VISCOSITY_VARIANTS,
        "ZografosEtAl1987",
    ),
    "bulk_phase_partitioning": (
        _NULL_VARIANTS | misc_families.BULK_PHASE_PARTITIONING_VARIANTS, "Null"
    ),
}


def _default_seed():
    # reference PySDM/physics/constants.py:50-54
    return 44 if "CI" in os.environ else time.time_ns() % (2**31)


class Formulae:
    """selects variants + constants; attribute access yields bound namespaces
    (e.g. ``formulae.saturation_vapour_pressure.pvs_water(T)``)"""

    def __init__(
        self,
        *,
        constants: dict = None,
        seed: int = None,
        fastmath: bool = True,  # accepted for API parity; XLA handles fast-math
        handle_all_breakups: bool = False,
        **variant_choices,
    ):
        for family in variant_choices:
            if family not in _FAMILIES:
                raise ValueError(f"unknown formula family: {family}")
        self.constants = make_constants(constants)
        self.seed = _default_seed() if seed is None else seed
        self.fastmath = fastmath
        self.handle_all_breakups = handle_all_breakups
        self._variant_names = {}

        for family, (variants, default) in _FAMILIES.items():
            name = variant_choices.get(family, default)
            if name in variants:
                bound = _bind(variants[name], self.constants, name)
            elif "+" in name and all(
                part in variants for part in name.split("+")
            ):
                bound = _bind_composed(
                    [variants[part] for part in name.split("+")],
                    self.constants,
                    name,
                )
            else:
                raise ValueError(
                    f"unknown variant {name!r} for family {family!r};"
                    f" known: {sorted(variants)}"
                )
            self._variant_names[family] = name
            setattr(self, family, bound)

    def __str__(self):
        return "Formulae(" + ", ".join(
            f"{k}={v}" for k, v in sorted(self._variant_names.items())
        ) + ")"

    def get_constant(self, key):
        return getattr(self.constants, key)
