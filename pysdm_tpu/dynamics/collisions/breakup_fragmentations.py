"""Fragmentation functions (parity: reference
``PySDM/dynamics/collisions/breakup_fragmentations/``). Each returns
``(n_fragment, fragment_mass)`` per sorted slot given the pair's attributes
and a u01 draw. Basic limiters (NaN/zero/oversize fragments, reference
``fragmentation_methods.py:_fragmentation_limiters_body``) are applied
centrally in ``ops.breakup``; per-class vmin/nfmax limiting uses
``apply_limiters`` below with the reference's branch order."""

import numpy as np
import jax.numpy as jnp


def apply_limiters(frag_volume, total_volume, *, vmin=0.0, nfmax=None):
    """reference limiter order: clip fragment to the pair total; cap the
    fragment count at nfmax; fragments below vmin suppress breakup
    (fragment = whole pair)"""
    fv = jnp.where(
        jnp.isnan(frag_volume) | (frag_volume <= 0), total_volume, frag_volume
    )
    fv = jnp.minimum(fv, total_volume)
    if nfmax is not None:
        too_many = total_volume / fv > nfmax
        fv = jnp.where(too_many, total_volume / nfmax,
                       jnp.where(fv < vmin, total_volume, fv))
    else:
        fv = jnp.where(fv < vmin, total_volume, fv)
    return fv


class AlwaysN:
    required_attributes = ("water mass",)

    def __init__(self, n=1):
        self.n = n

    def register(self, builder):
        builder.request_attribute("water mass")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        mass_sum = attrs_a["water mass"] + attrs_b["water mass"]
        n_fragment = jnp.full_like(mass_sum, float(self.n))
        return n_fragment, mass_sum / self.n


class ConstantMass:
    """every fragment has the prescribed mass"""

    required_attributes = ("water mass",)

    def __init__(self, c):
        self.c = c

    def register(self, builder):
        builder.request_attribute("water mass")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        mass_sum = attrs_a["water mass"] + attrs_b["water mass"]
        fragment_mass = jnp.full_like(mass_sum, self.c)
        return mass_sum / fragment_mass, fragment_mass


class Exponential:
    """exponentially-distributed fragment size (reference expon_frag semantics)"""

    required_attributes = ("water mass",)

    def __init__(self, scale, vmin=0.0, nfmax=None):
        self.scale = scale  # volume scale
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("water mass")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        mass_sum = attrs_a["water mass"] + attrs_b["water mass"]
        frag_volume = -self.scale * jnp.log(jnp.maximum(1 - u01, 1e-30))
        frag_volume = jnp.maximum(frag_volume, self.vmin)
        fragment_mass = frag_volume * const.rho_w
        n_fragment = mass_sum / jnp.maximum(fragment_mass, 1e-300)
        if self.nfmax is not None:
            n_fragment = jnp.minimum(n_fragment, self.nfmax)
            fragment_mass = mass_sum / n_fragment
        return n_fragment, fragment_mass


class Gaussian:
    """normally-distributed fragment volume"""

    required_attributes = ("water mass",)

    def __init__(self, mu, sigma, vmin=0.0, nfmax=None):
        self.mu = mu
        self.sigma = sigma
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("water mass")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        mass_sum = attrs_a["water mass"] + attrs_b["water mass"]
        frag_volume = self.mu + self.sigma * formulae.trivia.erfinv_approx(
            jnp.clip(2 * u01 - 1, -0.999999, 0.999999)
        )
        frag_volume = jnp.maximum(frag_volume, self.vmin)
        fragment_mass = frag_volume * const.rho_w
        n_fragment = mass_sum / jnp.maximum(fragment_mass, 1e-300)
        if self.nfmax is not None:
            n_fragment = jnp.minimum(n_fragment, self.nfmax)
            fragment_mass = mass_sum / n_fragment
        return n_fragment, fragment_mass


class Feingold1988:
    """scaled exponential fragment-size pdf (Feingold et al. 1999; reference
    ``breakup_fragmentations/feingold1988.py``)"""

    required_attributes = ("water mass", "volume")

    def __init__(self, scale, fragtol=1e-3, vmin=0.0, nfmax=None):
        self.scale = scale
        self.fragtol = fragtol
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        x_plus_y = attrs_a["volume"] + attrs_b["volume"]
        frag_volume = -self.scale * jnp.log(
            jnp.maximum(1 - u01 * self.scale / x_plus_y, self.fragtol)
        )
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        n_fragment = x_plus_y / frag_volume
        return n_fragment, frag_volume * const.rho_w


def _ll82_f1(erf, dl, dcoal):
    """filament mode 1 (reference ``fragmentation_function/lowlist82.py``
    params_f1): Gaussian at the large drop's diameter, height-normalised by
    a 10-iteration fixed-point for sigma. All diameters in cm."""
    H = 50.8 * dl ** (-0.718)
    mu = dl
    sigma = 1.0 / H
    for _ in range(10):
        sigma = (
            1.0 / H * np.sqrt(2 / np.pi)
            / (1 + erf((dcoal - dl) / (np.sqrt(2.0) * sigma)))
        )
    return H, mu, sigma


def _ll82_f2(ds):
    H = 4.18 * ds ** (-1.17)
    return H, ds, 1.0 / (np.sqrt(2 * np.pi) * H)


def _ll82_f3(erf, ds, dl):
    """filament mode 3 (lognormal satellite fragments), params_f3 with the
    degenerate (sigma->0 / H->0) exits folded in via where-selection"""
    Ff1 = jnp.maximum(
        0.0,
        (-2.25e4 * (dl - 0.403) ** 2 - 37.9) * ds**2.5
        + 9.67 * (dl - 0.170) ** 2
        + 4.95,
    )
    Ff2 = 1.02e4 * ds**2.83 + 2.0
    ds0 = jnp.maximum(0.04, (Ff1 / 2.83) ** (1 / 1.02e4))
    Ff = jnp.where(ds > ds0, jnp.maximum(2.0, Ff1), jnp.maximum(2.0, Ff2))
    Dff3 = 0.241 * ds + 0.0129
    Pf301 = 1.68e5 * ds**2.33
    Pf302 = jnp.maximum(
        0.0,
        (43.4 * (dl + 1.81) ** 2 - 159.0) / ds
        - 3870 * (dl - 0.285) ** 2
        - 58.1,
    )
    alpha = (ds - ds0) / (0.2 * ds0)
    Pf303 = alpha * Pf301 + (1 - alpha) * Pf302
    Pf0 = jnp.where(ds < ds0, Pf301, jnp.where(ds > 1.2 * ds0, Pf302, Pf303))
    sigma = 10 * Dff3
    mu = jnp.log(Dff3) + sigma**2
    H = Pf0 * Dff3 / jnp.exp(-0.5 * sigma**2)
    dead = jnp.zeros_like(ds, dtype=bool)
    for _ in range(10):
        dead = dead | (sigma == 0.0) | (H == 0.0)
        safe_sigma = jnp.where(dead, 1.0, sigma)
        safe_H = jnp.where(dead, 1.0, H)
        sigma = (
            np.sqrt(2 / np.pi) * (Ff - 2.0) / safe_H
            / (1 - erf((jnp.log(0.01) - mu) / np.sqrt(2.0) / safe_sigma))
        )
        mu = jnp.log(Dff3) + sigma**2
        H = Pf0 * Dff3 / jnp.exp(-0.5 * sigma**2)
    lg = jnp.log(ds0)
    return (
        jnp.where(dead, 0.0, H),
        jnp.where(dead, lg, mu),
        jnp.where(dead, lg, sigma),
    )


def _ll82_s1(erf, dl, ds, dcoal):
    H = 100.0 * jnp.exp(-3.25 * ds)
    mu = dl
    sigma = 1.0 / H
    for _ in range(10):
        sigma = (
            1.0 / H * np.sqrt(2 / np.pi)
            / (1 + erf((dcoal - dl) / (np.sqrt(2.0) * sigma)))
        )
    return H, mu, sigma


def _ll82_s2(erf, dl, ds, St):
    Dss2 = 0.254 * ds**0.413 * jnp.exp(3.53 * ds**2.51 * (dl - ds))
    bstar = 14.2 * jnp.exp(-17.2 * ds)
    Ps20 = 0.23 * ds ** (-3.93) * dl**bstar
    sigma = 10 * Dss2
    mu = jnp.log(Dss2) + sigma**2
    H = Ps20 * Dss2 / jnp.exp(-0.5 * sigma**2)
    Fs = 5 * erf((St - 2.52e-6) / 1.85e-6) + 6
    for _ in range(10):
        sigma = (
            np.sqrt(2 / np.pi) * (Fs - 1.0) / H
            / (1 - erf((jnp.log(0.01) - mu) / np.sqrt(2.0) / sigma))
        )
        mu = jnp.log(Dss2) + sigma**2
        H = Ps20 * Dss2 / jnp.exp(-0.5 * sigma**2)
    return H, mu, sigma


def _ll82_d1(erf, W1, dl, dcoal, CKE):
    mu = dl * (1 - jnp.exp(-3.70 * (3.10 - W1)))
    H = 1.58e-5 * CKE ** (-1.22)
    sigma = 1.0 / H
    for _ in range(10):
        sigma = (
            1.0 / H * np.sqrt(2 / np.pi)
            / (1 + erf((dcoal - mu) / (np.sqrt(2.0) * sigma)))
        )
    return H, mu, sigma


def _ll82_d2(erf, ds, dl, CKE):
    Ddd2 = jnp.exp(-17.4 * ds - 0.671 * (dl - ds)) * ds
    bstar = 0.007 * ds ** (-2.54)
    Pd20 = 0.0884 * ds ** (-2.52) * jnp.maximum(dl - ds, 1e-30) ** bstar
    sigma = 10 * Ddd2
    mu = jnp.log(Ddd2) + sigma**2
    H = Pd20 * Ddd2 / jnp.exp(-0.5 * sigma**2)
    Fd = jnp.maximum(1.0, 297.5 + 23.7 * jnp.log(CKE))
    dead = Fd == 1.0
    for _ in range(10):
        dead = dead | (sigma == 0.0) | (H <= 0.1) | (sigma >= 1.0)
        safe_sigma = jnp.where(dead, 0.5, sigma)
        safe_H = jnp.where(dead, 1.0, H)
        sigma = (
            np.sqrt(2 / np.pi) * (Fd - 1.0) / safe_H
            / (1 - erf((jnp.log(0.01) - mu) / np.sqrt(2.0) / safe_sigma))
        )
        mu = jnp.log(Ddd2) + sigma**2
        H = Pd20 * Ddd2 / jnp.exp(-0.5 * sigma**2)
    lg = jnp.log(Ddd2)
    return (
        jnp.where(dead, 0.0, H),
        jnp.where(dead, lg, mu),
        jnp.where(dead, lg, sigma),
    )


class LowList1982Nf:
    """Low & List 1982 (JAS 39) filament/sheet/disk breakup fragment-size
    distribution (reference ``breakup_fragmentations/lowlist82.py``,
    ``physics/fragmentation_function/lowlist82.py``, and the
    ``_ll82_fragmentation_body`` kernel): breakup-type probabilities
    Rf/Rs/Rd from collision kinetic energy and Weber numbers, then a
    per-type Gaussian/lognormal mixture sampled by inverse-CDF. Branchy
    per-pair control flow becomes where-selection over all branches —
    redundant elementwise lanes are cheaper than divergence bookkeeping."""

    required_attributes = (
        "water mass", "volume", "radius", "relative fall velocity",
    )

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        from jax.scipy.special import erf

        const = formulae.constants
        tol = 1e-8
        erfinv = formulae.trivia.erfinv_approx
        va, vb = attrs_a["volume"], attrs_b["volume"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        ua, ub = (
            attrs_a["relative fall velocity"],
            attrs_b["relative fall velocity"],
        )
        x_plus_y = va + vb
        safe_sum = jnp.maximum(x_plus_y, 1e-300)
        ds_m = 2 * jnp.minimum(ra, rb)
        dl_m = 2 * jnp.maximum(ra, rb)
        dcoal_m = (safe_sum / (const.PI / 6)) ** (1 / 3)
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * safe_sum ** (2 / 3)
        St = const.PI * const.sgm_w * (ds_m**2 + dl_m**2)
        CKE = const.rho_w / 2 * (va * vb / safe_sum) * (ua - ub) ** 2
        CKE = jnp.maximum(CKE, 1e-300)
        We = CKE / Sc
        W2 = CKE / St

        # breakup-type ratios (reference ``ll82_Nr``)
        Rf = jnp.where(CKE >= 0.893e-6, 1.11e-4 * CKE ** (-0.654), 1.0)
        Rs = jnp.where(We >= 0.86, 0.685 * (1 - jnp.exp(-1.63 * (W2 - 0.86))), 0.0)
        Rd = jnp.where(Rs + Rf > 1.0, 0.0, 1.0 - Rs - Rf)

        # diameters in cm for the parameterisation
        ds = jnp.maximum(ds_m / const.CM, 1e-10)
        dl = jnp.maximum(dl_m / const.CM, 1e-10)
        dcoal = dcoal_m / const.CM

        def gauss(mu, sigma, X):
            return mu + np.sqrt(2.0) * sigma * erfinv(2 * X - 1)

        def logn(mu, sigma, X):
            return jnp.exp(mu + np.sqrt(2.0) * sigma * erfinv(2 * X - 1))

        # --- filament branch ---
        Hf1, mu_f1, sg_f1 = _ll82_f1(erf, dl, dcoal)
        Hf2, mu_f2, sg_f2 = _ll82_f2(ds)
        Hf3, mu_f3, sg_f3 = _ll82_f3(erf, ds, dl)
        w1 = Hf1 * mu_f1
        w2 = Hf2 * mu_f2
        w3 = Hf3 * jnp.exp(mu_f3)
        wsum = jnp.maximum(w1 + w2 + w3, 1e-300)
        rf = u01 / jnp.maximum(Rf, 1e-300)
        d_f = jnp.where(
            rf <= w1 / wsum,
            gauss(mu_f1, sg_f1, jnp.maximum(rf * wsum / jnp.maximum(w1, 1e-300), tol)),
            jnp.where(
                rf <= (w1 + w2) / wsum,
                gauss(mu_f2, sg_f2, (rf * wsum - w1) / jnp.maximum(w2, 1e-300)),
                logn(
                    mu_f3, sg_f3,
                    jnp.minimum(
                        (rf * wsum - w1 - w2) / jnp.maximum(w3, 1e-300),
                        1.0 - tol,
                    ),
                ),
            ),
        )

        # --- sheet branch ---
        Hs1, mu_s1, sg_s1 = _ll82_s1(erf, dl, ds, dcoal)
        Hs2, mu_s2, sg_s2 = _ll82_s2(erf, dl, ds, St)
        v1 = Hs1 * mu_s1
        v2 = Hs2 * jnp.exp(mu_s2)
        vsum = jnp.maximum(v1 + v2, 1e-300)
        rs = (u01 - Rf) / jnp.maximum(Rs, 1e-300)
        d_s = jnp.where(
            rs <= v1 / vsum,
            gauss(mu_s1, sg_s1, jnp.maximum(rs * vsum / jnp.maximum(v1, 1e-300), tol)),
            logn(
                mu_s2, sg_s2,
                jnp.minimum((rs * vsum - v1) / jnp.maximum(v2, 1e-300), 1.0 - tol),
            ),
        )

        # --- disk branch ---
        Hd1, mu_d1, sg_d1 = _ll82_d1(erf, We, dl, dcoal, CKE)
        Hd2, mu_d2, sg_d2 = _ll82_d2(erf, ds, dl, CKE)
        q1 = Hd1 * mu_d1
        qsum = jnp.maximum(q1 + Hd2, 1e-300)
        rd = (u01 - Rf - Rs) / jnp.maximum(Rd, 1e-300)
        d_d = jnp.where(
            rd <= q1 / qsum,
            gauss(mu_d1, sg_d1, jnp.maximum(rd * qsum / jnp.maximum(q1, 1e-300), tol)),
            logn(
                mu_d2, sg_d2,
                jnp.minimum((rd * qsum - q1) / jnp.maximum(Hd2, 1e-300), 1.0 - tol),
            ),
        )

        diameter_cm = jnp.where(
            u01 <= Rf, d_f, jnp.where(u01 <= Rf + Rs, d_s, d_d)
        )
        frag_volume = (diameter_cm * 0.01) ** 3 * const.PI / 6
        # small-large-drop and degenerate-pair special cases
        frag_volume = jnp.where(
            dl_m <= 0.4e-3,
            dcoal_m**3 * const.PI / 6,
            jnp.where((ds_m <= 0.0) | (dl_m <= 0.0), 1e-18, frag_volume),
        )
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w


class SLAMS:
    """Stochastic Lagrangian Aggregates Model plankton-poop spectrum
    (Jokulsdottir & Archer 2016; reference ``breakup_fragmentations/slams.py``):
    P(n fragments) ~ 0.91 (n+2)^-1.56, n in 0..21"""

    required_attributes = ("water mass", "volume")

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax
        probs = np.cumsum(0.91 * (np.arange(22) + 2.0) ** -1.56)
        self._cum_probs = probs

    def register(self, builder):
        builder.request_attribute("volume")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        x_plus_y = attrs_a["volume"] + attrs_b["volume"]
        cum = jnp.asarray(self._cum_probs, dtype=u01.dtype)
        idx = jnp.searchsorted(cum, u01)  # first n with rand < cumprob
        n_fragment = jnp.where(idx < 22, idx + 2, 1).astype(u01.dtype)
        frag_volume = apply_limiters(
            x_plus_y / n_fragment, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w


class Straub2010Nf:
    """Straub et al. 2010 four-mode fragment-size distribution (reference
    ``breakup_fragmentations/straub2010.py`` + ``fragmentation_methods.py``
    straub kernels): modes weighted by Nr1..Nr4(CW, gam) with the fourth
    mode's diameter fixed by mass conservation."""

    required_attributes = ("water mass", "volume", "radius", "relative fall velocity")

    def __init__(self, vmin=0.0, nfmax=None):
        self.vmin = vmin
        self.nfmax = nfmax

    def register(self, builder):
        builder.request_attribute("radius")
        builder.request_attribute("volume")
        builder.request_attribute("relative fall velocity")

    def pairwise(self, formulae, attrs_a, attrs_b, u01):
        const = formulae.constants
        va, vb = attrs_a["volume"], attrs_b["volume"]
        ra, rb = attrs_a["radius"], attrs_b["radius"]
        ua, ub = (
            attrs_a["relative fall velocity"],
            attrs_b["relative fall velocity"],
        )
        x_plus_y = va + vb
        v_max = jnp.maximum(va, vb)
        ds = 2 * jnp.minimum(ra, rb)
        gam = jnp.maximum(ra, rb) / jnp.maximum(jnp.minimum(ra, rb), 1e-30)
        Sc = const.PI * const.sgm_w * (6 / const.PI) ** (2 / 3) * x_plus_y ** (2 / 3)
        CKE = (
            const.rho_w
            / 2
            * (va * vb / jnp.maximum(x_plus_y, 1e-300))
            * (ua - ub) ** 2
        )
        We = CKE / jnp.maximum(Sc, 1e-300)
        CW = We * CKE / 1e-6  # CKE*We / microjoule (reference straub wrapper)

        # mode weights (reference ``straub_Nr``)
        Nr1 = jnp.where(gam * CW >= 7.0, 0.088 * (gam * CW - 7.0), 0.0)
        Nr2 = jnp.where(CW >= 21.0, 0.22 * (CW - 21.0), 0.0)
        Nr3 = jnp.where(
            CW >= 21.0, jnp.where(CW <= 46.0, 0.04 * (46.0 - CW), 0.0), 1.0
        )
        Nr4 = jnp.ones_like(CW)

        CM = 1e-2  # centimetre
        E_D1 = const.STRAUB_E_D1
        sigma1 = jnp.sqrt(
            jnp.log(jnp.maximum(CW / 64 / 100 * CM * CM / 12 / E_D1**2 + 1, 1.0))
        )
        mu1 = jnp.log(E_D1) - sigma1**2 / 2
        sigma2 = jnp.maximum(0.0, 7 * (CW - 21) * CM / 1000) / jnp.sqrt(12.0)
        mu2 = const.STRAUB_MU2
        sigma3 = (1 + 0.76 * jnp.sqrt(CW)) * CM / 100 / jnp.sqrt(12.0)
        mu3 = 0.9 * ds

        # mass remainder (reference ``straub_mass_remainder``)
        M1 = Nr1 * jnp.exp(3 * mu1 + 9 * sigma1**2 / 2)
        M2 = Nr2 * (mu2**3 + 3 * mu2 * sigma2**2)
        M3 = Nr3 * (mu3**3 + 3 * mu3 * sigma3**2)
        M4 = v_max * 6 / const.PI + ds**3 - M1 - M2 - M3
        d34 = jnp.where(M4 > 0, jnp.exp(jnp.log(jnp.maximum(M4, 1e-300)) / 3), 0.0)
        M4 = jnp.maximum(M4, 0.0)
        Nrt = M1 + M2 + M3 + M4

        safe_Nrt = jnp.maximum(Nrt, 1e-300)
        u = jnp.clip(u01, 1e-12, 1 - 1e-12)
        X1 = jnp.clip(u * safe_Nrt / jnp.maximum(M1, 1e-300), 1e-12, 1 - 1e-12)
        X2 = jnp.clip(
            (u * safe_Nrt - M1) / jnp.maximum(M2, 1e-300), 1e-12, 1 - 1e-12
        )
        X3 = jnp.clip(
            (u * safe_Nrt - M1 - M2) / jnp.maximum(M3, 1e-300), 1e-12, 1 - 1e-12
        )
        erfinv = formulae.trivia.erfinv_approx
        d_1 = jnp.exp(mu1 + jnp.sqrt(2.0) * sigma1 * erfinv(X1))
        d_2 = mu2 + jnp.sqrt(2.0) * sigma2 * erfinv(X2)
        d_3 = mu3 + jnp.sqrt(2.0) * sigma3 * erfinv(X3)
        diameter = jnp.where(
            u < M1 / safe_Nrt,
            d_1,
            jnp.where(
                u < (M1 + M2) / safe_Nrt,
                d_2,
                jnp.where(u < (M1 + M2 + M3) / safe_Nrt, d_3, d34),
            ),
        )
        diameter = jnp.where(Nrt > 0, diameter, 0.0)
        frag_volume = diameter**3 * const.PI / 6
        frag_volume = apply_limiters(
            frag_volume, x_plus_y, vmin=self.vmin, nfmax=self.nfmax
        )
        return x_plus_y / frag_volume, frag_volume * const.rho_w


class ExponFrag(Exponential):
    """DEPRECATED alias of Exponential (reference ``expon_frag.py``)"""
