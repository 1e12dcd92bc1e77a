"""Collision kernels (parity: reference
``PySDM/dynamics/collisions/collision_kernels/``). Each kernel exposes
``required_attributes`` and a vectorized ``pairwise(formulae, attrs_a, attrs_b)``
evaluated at every sorted slot (partner = next slot)."""

import numpy as np
import jax.numpy as jnp
from scipy import special


class Golovin:
    """sum-of-volumes kernel with analytic solution (Golovin 1963)"""

    required_attributes = ("volume",)

    def __init__(self, b):
        self.b = b
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.b * (attrs_a["volume"] + attrs_b["volume"])

    def analytic_solution(self, x, t, x_0, N_0):
        """mass-density solution of the Smoluchowski equation for K = b(x+x')
        (same closed form as reference ``collision_kernels/golovin.py:24-45``)"""
        tau = 1 - np.exp(-N_0 * self.b * x_0 * t)
        sqrt_tau = np.sqrt(tau)
        result = (
            (1 - tau)
            / (x * sqrt_tau)
            * special.ive(1, 2 * x / x_0 * sqrt_tau)
            * np.exp(-(1 + tau - 2 * sqrt_tau) * x / x_0)
        )
        return result


class ConstantK:
    required_attributes = ("volume",)

    def __init__(self, a):
        self.a = a

    def register(self, builder):
        pass

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.a + 0.0 * attrs_a["volume"]


class Linear:
    """K = a + b * (v + v') (reference ``collision_kernels/linear.py``)"""

    required_attributes = ("volume",)

    def __init__(self, a, b):
        self.a = a
        self.b = b

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.a + self.b * (attrs_a["volume"] + attrs_b["volume"])


class Geometric:
    """gravitational geometric-sweepout kernel
    (reference ``collision_kernels/geometric.py``):
    K = E_c * pi * (r + r')^2 * |v_t - v_t'|"""

    required_attributes = ("radius", "relative fall velocity")

    def __init__(self, collection_efficiency=1.0, x="volume"):
        self.collection_efficiency = collection_efficiency
        self.x = x

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        r_sum = attrs_a["radius"] + attrs_b["radius"]
        dv = jnp.abs(
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        )
        return np.pi * self.collection_efficiency * r_sum**2 * dv


class SimpleGeometric:
    """geometric kernel without fall velocities
    (reference ``collision_kernels/simple_geometric.py``):
    K = C * (r + r')^2 * |A - A'|"""

    required_attributes = ("radius", "area")

    def __init__(self, C):
        self.C = C

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("area")

    def pairwise(self, formulae, attrs_a, attrs_b):
        r_sum = attrs_a["radius"] + attrs_b["radius"]
        d_area = jnp.abs(attrs_a["area"] - attrs_b["area"])
        return self.C * r_sum**2 * d_area


def berry_1967_linear_collection_efficiency(params, r_big, r_small, unit=1e-6):
    """Berry 1967 'linear collection efficiency' fit Y (dimensionless radius
    multiplier); semantics per reference ``collisions_methods.py:744-782``"""
    A, B, D1, D2, E1, E2, F1, F2, G1, G2, G3, Mf, Mg = params
    r = r_big / unit
    r_s = r_small / unit
    p = r_s / jnp.where(r > 0, r, 1.0)
    G = (G1 / r) ** Mg + G2 + G3 * r
    one_minus_p = jnp.clip(1.0 - p, 0.0, 1.0)
    Gp = one_minus_p**G
    D = D1 / r**D2
    E = E1 / r**E2
    F = (F1 / r) ** Mf + F2
    safe_p = jnp.where((p > 0) & (p < 1), p, 0.5)
    safe_Gp = jnp.where(Gp != 0, Gp, 1.0)
    Y = A + B * p + D / safe_p**F + E / safe_Gp
    Y = jnp.where((p > 0) & (p < 1) & (Gp != 0), Y, 0.0)
    return jnp.maximum(Y, 0.0)


class Parameterized:
    """gravitational kernel with Berry-1967-parameterized efficiency:
    K = pi * (Y * r_max)^2 * |v_t - v_t'|
    (reference ``collision_kernels/impl/parameterized.py``)"""

    required_attributes = ("radius", "relative fall velocity")

    def __init__(self, params):
        self.params = params

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        r_big = jnp.maximum(attrs_a["radius"], attrs_b["radius"])
        r_small = jnp.minimum(attrs_a["radius"], attrs_b["radius"])
        Y = berry_1967_linear_collection_efficiency(self.params, r_big, r_small)
        dv = jnp.abs(
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        )
        return np.pi * (Y * r_big) ** 2 * dv


class Hydrodynamic(Parameterized):
    """Berry 1967 hydrodynamic-capture kernel (reference hydrodynamic.py)"""

    def __init__(self):
        super().__init__((1, 1, -27, 1.65, -58, 1.9, 15, 1.13, 16.7, 1, 0.004, 4, 8))


class Electric(Parameterized):
    """3000 V/cm electric-field kernel (Berry 1967; reference electric.py)"""

    def __init__(self):
        super().__init__(
            (1, 1, -7, 1.78, -20.5, 1.73, 0.26, 1.47, 1, 0.82, -0.003, 4.4, 8)
        )
