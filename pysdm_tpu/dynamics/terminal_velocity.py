"""Terminal velocity approximations (parity: reference
``PySDM/dynamics/terminal_velocity/``): Gunn & Kinzer 1949 table interpolation
(with Beard-style small-radius correction), RogersYau (in physics), and
PowerSeries.

The lookup table is built once on host (scipy RBF over the
published Table 2 data, identical grid: 601 points over [0, 0.6 cm]) and the
runtime evaluation is a vectorized gather + linear interpolation.
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

# Gunn & Kinzer 1949, Table 2: drop diameter [mm] -> terminal velocity [cm/s]
_GK_DIAMETERS_MM = np.array(
    [0.078, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.2, 1.4, 1.6,
     1.8, 2.0, 2.2, 2.4, 2.6, 2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0, 4.2, 4.4,
     4.6, 4.8, 5.0, 5.2, 5.4, 5.6, 5.8]
)
_GK_VELOCITIES_CM_S = np.array(
    [18, 27, 72, 117, 162, 206, 247, 287, 327, 367, 403, 464, 517, 565, 609,
     649, 690, 727, 757, 782, 806, 826, 844, 860, 872, 883, 892, 898, 903,
     907, 909, 912, 914, 916, 917]
)

_FACTOR = 100000  # inverse grid step (1e-5 m), reference gunn_and_kinzer.py:118
_MAX_RADIUS = 0.6e-2  # 0.6 cm


def _beard_small_r_velocity(radius_m):
    """Beard 1976-style small-drop terminal velocity (reference
    ``gunn_and_kinzer.py`` TpDependent.make, small-radius branch at
    T=293.15 K, p=1000 hPa)"""
    si_cm = 1e-2
    T = 293.15
    p = 1000e2
    p0 = 1013.25e2
    rho0 = 1.204
    n = 1.832e-5
    rho = 0.348 * p / T
    l0 = 6.62e-6 * si_cm
    n0 = 1.818e-5
    l = l0 * (n / n0) * (p0 * rho0 / p * rho) ** 0.5
    c4 = np.array([10.5035, 1.08750, -0.133245, -0.00659969])
    r = radius_m / si_cm
    f4 = (n0 / n) * (1 + 1.255 * l / r) / (1 + 1.255 * l0 / r)
    log2r = np.log(2 * r)
    sum_r = sum(c4[j] * log2r**j for j in range(4))
    return f4 * np.exp(sum_r) * si_cm


@lru_cache(maxsize=4)
def _gk_table(small_r_limit=40e-6):
    from scipy.interpolate import Rbf

    ir = _GK_DIAMETERS_MM * 1e-3 / 2  # radius in metres
    iu = _GK_VELOCITIES_CM_S / 100  # m/s
    rbf = Rbf(ir, iu)
    num = 6 * _FACTOR // 1000 + 1
    space, step = np.linspace(0.0, _MAX_RADIUS, num, retstep=True)
    u = rbf(space)
    u[0] = 0.0
    small = (space < small_r_limit) & (space > 0)
    u[small] = _beard_small_r_velocity(space[small])
    b = np.append(np.diff(u), [u[-1] - u[-2]]) / step
    return u, b


def gunn_kinzer_v_term(const, radius, small_r_limit=40e-6):
    """vectorized linear-interpolated Gunn-Kinzer terminal velocity [m/s]"""
    a_np, b_np = _gk_table(small_r_limit)
    # reference interpolation kernel (terminal_velocity_methods.py:16-25):
    # r_id = int(factor*r); output = a[r_id] + ((factor*r) % 1)/factor * b[r_id]
    tab = jnp.asarray(np.stack([a_np, b_np], axis=1), dtype=jnp.float32)
    scaled = jnp.clip(radius, 0.0, _MAX_RADIUS) * _FACTOR
    idx = jnp.clip(scaled.astype(jnp.int32), 0, tab.shape[0] - 1)
    r_rest = (scaled - idx) / _FACTOR
    ab = tab[idx]
    value = ab[:, 0].astype(radius.dtype) + r_rest * ab[:, 1].astype(
        radius.dtype
    )
    return jnp.where(radius < 0, 0.0, value)


class PowerSeries:
    """user-specified power-law terminal velocity (reference power_series.py)"""

    def __init__(self, *, prefactors=None, powers=None):
        self.prefactors = np.array(prefactors or [2.0e-1])
        self.powers = np.array(powers or [1 / 6])
        assert len(self.prefactors) == len(self.powers)
        pi43 = 4 / 3 * np.pi
        self.prefactors = np.array(
            [
                pref * pi43**p / (1e-6) ** (3 * p)
                for pref, p in zip(self.prefactors, self.powers)
            ]
        )

    def __call__(self, radius):
        v = 0.0
        for pref, p in zip(self.prefactors, self.powers):
            v = v + pref * jnp.power(radius, 3 * p)
        return v
