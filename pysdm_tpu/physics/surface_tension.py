"""Surface-tension variants with organic surface partitioning (parity:
reference ``PySDM/physics/surface_tension/``): Constant (in misc_families),
CompressedFilmOvadnevaite (Ovadnevaite et al. 2017 / Lowe et al. 2019),
CompressedFilmRuehl and SzyszkowskiLangmuir (Ruehl et al. 2016).

The Ruehl implicit isotherm solve — per-droplet TOMS748 in the
reference (``compressed_film_ruehl.py``) — is a fixed-count vectorized
bisection over the whole particle axis (branch-free, jit-traceable).
"""

import jax.numpy as jnp


class CompressedFilmOvadnevaite:
    """monolayer compressed-film: sigma is the coverage-weighted mean of
    water and organic surface tensions (reference
    ``compressed_film_ovadnevaite.py``)"""

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        r_wet = ((3 * v_wet) / (4 * const.PI)) ** (1 / 3)
        v_delta = v_wet - const.PI_4_3 * (r_wet - const.delta_min) ** 3
        v_beta = f_org * v_dry
        c_beta = jnp.minimum(v_beta / v_delta, 1.0)
        return (1 - c_beta) * const.sgm_w + c_beta * const.sgm_org


def _ruehl_iso(const, T, v_wet, v_dry, f_org):
    """shared Ruehl-2016 isotherm quantities (Cb_iso, A_iso); the f_org == 0
    branch (pure water, reference's scalar ``if``) is handled by a safe
    denominator here and a ``where`` at the call sites"""
    f_org_safe = jnp.where(jnp.asarray(f_org) == 0, 1.0, jnp.asarray(f_org))
    r_wet = ((3 * v_wet) / (4 * const.PI)) ** (1 / 3)
    Cb_iso = (f_org_safe * v_dry / const.RUEHL_nu_org) / (
        v_wet / const.water_molar_volume
    )
    A_iso = (4 * const.PI * r_wet**2) / (
        f_org_safe * v_dry * const.N_A / const.RUEHL_nu_org
    )
    return Cb_iso, A_iso


class CompressedFilmRuehl:
    """compressed-film equation of state with bulk/surface partitioning
    solved from the isotherm (reference ``compressed_film_ruehl.py``,
    Ruehl et al. 2016 supplementary eqs. 13 & 15)"""

    N_BISECT = 64

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        Cb_iso, A_iso = _ruehl_iso(const, T, v_wet, v_dry, f_org)
        c = (const.RUEHL_m_sigma * const.N_A) / (2 * const.R_str * T)

        def minfun(f_surf):
            lhs = Cb_iso * (1 - f_surf) / const.RUEHL_C0
            rhs = jnp.exp(c * (const.RUEHL_A0**2 - (A_iso / f_surf) ** 2))
            return lhs - rhs

        lo = jnp.full_like(jnp.asarray(v_wet, dtype=jnp.result_type(float)),
                           1e-16)
        hi = jnp.ones_like(lo)
        flo = minfun(lo)
        for _ in range(CompressedFilmRuehl.N_BISECT):
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid)
            go_lo = flo * fmid < 0
            hi = jnp.where(go_lo, mid, hi)
            lo = jnp.where(go_lo, lo, mid)
            flo = jnp.where(go_lo, flo, fmid)
        f_surf = 0.5 * (lo + hi)

        sgm = const.sgm_w - (const.RUEHL_A0 - A_iso / f_surf) * const.RUEHL_m_sigma
        sgm = jnp.clip(sgm, const.RUEHL_sgm_min, const.sgm_w)
        return jnp.where(
            f_org == 0,
            const.sgm_w,
            jnp.where(f_org == 1, const.RUEHL_sgm_min, sgm),
        )


class SzyszkowskiLangmuir:
    """Szyszkowski-Langmuir equation of state; the partitioning quadratic is
    solved in closed form (reference ``szyszkowski_langmuir.py``)"""

    @staticmethod
    def sigma(const, T, v_wet, v_dry, f_org):
        Cb_iso, A_iso = _ruehl_iso(const, T, v_wet, v_dry, f_org)
        a = -const.RUEHL_A0 / A_iso
        b = (
            const.RUEHL_A0 / A_iso
            + (const.RUEHL_A0 / A_iso) * (const.RUEHL_C0 / Cb_iso)
            + 1.0
        )
        f_surf = (-b + jnp.sqrt(b**2 + 4 * a)) / (2 * a)  # c == -1
        sgm = const.sgm_w - (
            (const.R_str * T) / (const.RUEHL_A0 * const.N_A)
        ) * jnp.log1p(Cb_iso * (1 - f_surf) / const.RUEHL_C0)
        sgm = jnp.clip(sgm, const.RUEHL_sgm_min, const.sgm_w)
        return jnp.where(f_org == 0, const.sgm_w, sgm)


VARIANTS = {
    "CompressedFilmOvadnevaite": CompressedFilmOvadnevaite,
    "CompressedFilmRuehl": CompressedFilmRuehl,
    "SzyszkowskiLangmuir": SzyszkowskiLangmuir,
}
