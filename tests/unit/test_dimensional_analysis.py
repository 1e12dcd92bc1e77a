"""Dimensional-homogeneity checks of the physics formula catalog via the
scale-covariance DimensionalAnalysis harness (this engine's counterpart
of the reference's Pint-based unit tests,
reference ``PySDM/physics/dimensional_analysis.py`` +
``tests/unit_tests/physics/``)."""

import numpy as np
import pytest

from pysdm_tpu.physics.dimensional_analysis import (
    AREA,
    DIFFUSIVITY,
    DIMENSIONLESS,
    DENSITY,
    DimensionalAnalysis,
    ENERGY_PER_MASS,
    GROWTH_RESISTANCE,
    LENGTH,
    MASS,
    PRESSURE,
    SURFACE_TENSION,
    TEMPERATURE,
    THERMAL_CONDUCTIVITY,
    VELOCITY,
    VOLUME,
    Dimension,
)


@pytest.fixture(scope="module")
def da():
    return DimensionalAnalysis()


T_TEST = np.asarray([253.0, 273.15, 283.0, 300.0])
P_TEST = np.asarray([600e2, 800e2, 1000e2, 1013e2])


class TestSaturationVapourPressure:
    @staticmethod
    @pytest.mark.parametrize(
        "variant",
        (
            "FlatauWalkoCotton",
            "AugustRocheMagnus",
            "Bolton1980",
            "Lowe1977",
            "MurphyKoop2005",
            "Wexler1976",
        ),
    )
    def test_pvs_water_is_pressure(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"saturation_vapour_pressure": variant}
        )
        da.check(
            lambda f: f.saturation_vapour_pressure.pvs_water,
            in_dims=(TEMPERATURE,),
            out_dim=PRESSURE,
            args=(T_TEST,),
        )

    @staticmethod
    def test_pvs_ice_is_pressure(da):
        da.check(
            lambda f: f.saturation_vapour_pressure.pvs_ice,
            in_dims=(TEMPERATURE,),
            out_dim=PRESSURE,
            args=(T_TEST,),
        )


class TestLatentHeat:
    @staticmethod
    @pytest.mark.parametrize(
        "variant", ("Kirchhoff", "Lowe2019", "Constant")
    )
    def test_lv_is_energy_per_mass(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"latent_heat_vapourisation": variant}
        )
        da.check(
            lambda f: f.latent_heat_vapourisation.lv,
            in_dims=(TEMPERATURE,),
            out_dim=ENERGY_PER_MASS,
            args=(T_TEST,),
        )


class TestTrivia:
    @staticmethod
    def test_volume_radius_roundtrip_dims(da):
        da.check(
            lambda f: f.trivia.volume,
            in_dims=(LENGTH,),
            out_dim=VOLUME,
            args=(np.asarray([1e-6, 1e-5]),),
        )
        da.check(
            lambda f: f.trivia.radius,
            in_dims=(VOLUME,),
            out_dim=LENGTH,
            args=(np.asarray([1e-18, 1e-15]),),
        )


class TestStateVariableTriplet:
    @staticmethod
    def test_T_of_rhod_thd(da):
        da.check(
            lambda f: f.state_variable_triplet.T,
            in_dims=(DENSITY, TEMPERATURE),
            out_dim=TEMPERATURE,
            args=(np.asarray([1.1]), np.asarray([290.0])),
        )

    @staticmethod
    def test_p_of_rhod_T_qv(da):
        da.check(
            lambda f: f.state_variable_triplet.p,
            in_dims=(DENSITY, TEMPERATURE, DIMENSIONLESS),
            out_dim=PRESSURE,
            args=(np.asarray([1.1]), np.asarray([283.0]), np.asarray([0.01])),
        )


class TestDiffusion:
    @staticmethod
    def test_D_is_diffusivity(da):
        da.check(
            lambda f: f.diffusion_thermics.D,
            in_dims=(TEMPERATURE, PRESSURE),
            out_dim=DIFFUSIVITY,
            args=(T_TEST, P_TEST),
        )

    @staticmethod
    def test_K_is_conductivity(da):
        da.check(
            lambda f: f.diffusion_thermics.K,
            in_dims=(TEMPERATURE, PRESSURE),
            out_dim=THERMAL_CONDUCTIVITY,
            args=(T_TEST, P_TEST),
        )


class TestDropGrowth:
    @staticmethod
    def test_Fk_Fd_growth_resistances(da):
        T = np.asarray([283.0])
        da.check(
            lambda f: (
                lambda T, lv, K: f.drop_growth.Fk(T=T, lv=lv, K=K)
            ),
            in_dims=(TEMPERATURE, ENERGY_PER_MASS, THERMAL_CONDUCTIVITY),
            out_dim=GROWTH_RESISTANCE,
            args=(T, np.asarray([2.5e6]), np.asarray([2.4e-2])),
        )
        da.check(
            lambda f: (
                lambda T, pvs, D: f.drop_growth.Fd(T=T, pvs=pvs, D=D)
            ),
            in_dims=(TEMPERATURE, PRESSURE, DIFFUSIVITY),
            out_dim=GROWTH_RESISTANCE,
            args=(T, np.asarray([1220.0]), np.asarray([2.26e-5])),
        )

    @staticmethod
    def test_r_dr_dt_dims(da):
        da.check(
            lambda f: (
                lambda RH_eq, RH, Fk, Fd: f.drop_growth.r_dr_dt(
                    RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd
                )
            ),
            in_dims=(
                DIMENSIONLESS,
                DIMENSIONLESS,
                GROWTH_RESISTANCE,
                GROWTH_RESISTANCE,
            ),
            out_dim=DIFFUSIVITY,  # r dr/dt: m^2/s
            args=(
                np.asarray([1.001]),
                np.asarray([1.005]),
                np.asarray([1e8]),
                np.asarray([1e8]),
            ),
        )


class TestHygroscopicity:
    @staticmethod
    def test_RH_eq_dimensionless(da):
        r = np.asarray([1e-6])
        rd3 = np.asarray([1e-21])
        da.check(
            lambda f: f.hygroscopicity.RH_eq,
            in_dims=(
                LENGTH,
                TEMPERATURE,
                DIMENSIONLESS,
                VOLUME,
                SURFACE_TENSION,
            ),
            out_dim=DIMENSIONLESS,
            args=(r, np.asarray([283.0]), np.asarray([0.5]), rd3,
                  np.asarray([0.072])),
        )

    @staticmethod
    def test_r_cr_is_length(da):
        da.check(
            lambda f: f.hygroscopicity.r_cr,
            in_dims=(DIMENSIONLESS, VOLUME, TEMPERATURE, SURFACE_TENSION),
            out_dim=LENGTH,
            args=(
                np.asarray([0.5]),
                np.asarray([1e-21]),
                np.asarray([283.0]),
                np.asarray([0.072]),
            ),
        )


class TestSurfaceTension:
    @staticmethod
    @pytest.mark.parametrize(
        "variant", ("Constant", "CompressedFilmOvadnevaite")
    )
    def test_sigma_dims(variant):
        da = DimensionalAnalysis(
            formulae_kwargs={"surface_tension": variant}
        )
        da.check(
            lambda f: f.surface_tension.sigma,
            in_dims=(TEMPERATURE, VOLUME, VOLUME, DIMENSIONLESS),
            out_dim=SURFACE_TENSION,
            args=(
                np.asarray([283.0]),
                np.asarray([1e-17]),
                np.asarray([1e-20]),
                np.asarray([0.3]),
            ),
        )


class TestTerminalVelocity:
    @staticmethod
    def test_rogers_yau_is_velocity():
        da = DimensionalAnalysis(
            formulae_kwargs={"terminal_velocity": "RogersYau"}
        )
        da.check(
            lambda f: f.terminal_velocity.v_term,
            in_dims=(LENGTH,),
            out_dim=VELOCITY,
            args=(np.asarray([10e-6, 100e-6, 1e-3]),),
        )


class TestDetectsBugs:
    @staticmethod
    def test_catches_dimension_error():
        """sanity: a deliberately wrong claimed output dimension fails"""
        da = DimensionalAnalysis()
        with pytest.raises(AssertionError):
            da.check(
                lambda f: f.saturation_vapour_pressure.pvs_water,
                in_dims=(TEMPERATURE,),
                out_dim=LENGTH,  # wrong on purpose
                args=(T_TEST,),
            )
