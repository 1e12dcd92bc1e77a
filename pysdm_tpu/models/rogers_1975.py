"""Rogers 1975 (Atmosphere 13) fig. 1 — coupled supersaturation/drop-growth
ODE system for a monodisperse population in a constant-updraft parcel
(reference ``examples/PySDM_examples/Rogers_1975/fig_1.ipynb``; eqs. 1-10 +
appendix A.1-A.3 of the paper). The reference notebook integrates with
scipy LSODA over a Pint-aware state; here the same system is a fixed-step
RK4 under ``lax.scan`` — fully jittable, runs on any JAX device."""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics import si

#: paper's own coefficient set (appendix A; SI units) — deliberately NOT the
#: framework constants catalog: fig. 1 reproduces Rogers' numbers
C = namedtuple(
    "RogersConstants", ("R", "g", "L", "eps", "cp", "rho_L")
)(
    R=287.0 * si.J / si.kg / si.K,  # gas constant of (0.76 N2, 0.23 O2, 0.01 Ar)
    g=9.80665 * si.m / si.s**2,
    L=2.5e6 * si.J / si.kg,
    eps=0.622,
    cp=1005.0 * si.J / si.kg / si.K,
    rho_L=1000.0 * si.kg / si.m**3,
)


def thermal_conductivity(T):
    """eq. A.1 [J/m/s/K]"""
    return 2.42e-2 * (393.0 / (T + 120.0)) * (T / 273.0) ** 1.5


def D_over_K(p, T):
    """eq. A.2 [m^3 K / J]; p in Pa (the paper uses dyne/cm^2 = 0.1 Pa)"""
    return 8.28 / 2.42 * T / (p * 10.0)


def saturation_vapour_pressure(T):
    """eq. A.3 [Pa]; the paper's 2.75e12 ubar prefactor = 2.75e11 Pa"""
    return 2.75e11 * jnp.exp(-5.44e3 / T)


def derivatives(state, *, U, nu_0):
    """eqs. (1), (2), (5), (6), (8), (10) — state = (p, T, S, r)"""
    p, T, S, r = state
    rho = p / C.R / T  # eq. (8)
    dp_dt = -rho * C.g * U  # eq. (5)

    K = thermal_conductivity(T)
    Fk = C.L**2 * C.eps * C.rho_L / K / C.R / T**2
    Fd = C.R * T * C.rho_L / C.eps / D_over_K(p, T) / K / (
        saturation_vapour_pressure(T)
    )
    sigma = (S - 1) / (Fk + Fd)  # eq. (2)
    dr_dt = sigma / r  # eq. (1)
    dksi_dt = 4 * jnp.pi * C.rho_L * nu_0 * r**2 * dr_dt  # d/dt of eq. (4)
    dT_dt = T * C.R / C.cp * dp_dt / p + C.L / C.cp * dksi_dt  # eq. (6)

    Q1 = C.L * C.g * C.eps / C.R / C.cp / T**2 - C.g / C.R / T  # eq. (10)
    Q2 = C.R * T / C.eps / saturation_vapour_pressure(T) + (
        C.eps * C.L**2 / C.cp / T / p
    )
    dS_dt = Q1 * U - rho * Q2 * dksi_dt
    return jnp.asarray([dp_dt, dT_dt, dS_dt, dr_dt])


def fig_1(
    *,
    updraft=10 * si.m / si.s,
    droplet_concentration=200 / si.cm**3,
    p0=800 * si.mbar,
    T0=273.15 + 7,
    r0=8 * si.um,
    t_max=20 * si.s,
    dt=0.01 * si.s,
):
    """returns (t, S-1, r) trajectories (jitted RK4; reference notebook
    solves the same system with LSODA and max_step=0.5 s)"""
    rho0 = p0 / C.R / T0
    nu_0 = droplet_concentration / rho0  # per kg of air

    deriv = lambda y: derivatives(y, U=updraft, nu_0=nu_0)

    n_steps = int(round(t_max / dt))

    @jax.jit
    def integrate(y0):
        def rk4(y, _):
            k1 = deriv(y)
            k2 = deriv(y + dt / 2 * k1)
            k3 = deriv(y + dt / 2 * k2)
            k4 = deriv(y + dt * k3)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            return y, y

        _, ys = jax.lax.scan(rk4, y0, None, length=n_steps)
        return ys
    y0 = jnp.asarray([p0, T0, 1.0, r0])
    ys = np.asarray(integrate(y0))
    t = np.arange(1, n_steps + 1) * dt
    return {
        "t": t,
        "supersaturation": ys[:, 2] - 1,
        "radius": ys[:, 3],
        "pressure": ys[:, 0],
        "temperature": ys[:, 1],
    }
