"""Vectorized SDM collisional breakup (de Jong, Mackay et al. 2023).

Semantics-parity with the reference CPU kernels
(``PySDM/backends/impl_numba/methods/collisions_methods.py:62-243,248-311``),
re-designed for vectorized execution: the reference's per-pair serial loop in
``compute_transfer_multiplicities`` is a geometric recursion

    new_mult_k(g)  = mult_k * alpha * (1+beta)^(g-1)
    take_from_j(g) = mult_k * (1 + alpha * ((1+beta)^(g-1) - 1) / beta)

with ``alpha = (mass_j+mass_k)/fragment_mass`` and
``beta = mass_j/fragment_mass`` — so the largest admissible number of breakup
events ``gamma_j_k`` (the loop's exit point) has a closed form via logarithms,
evaluated branch-free for all pairs at once and corrected by +-2 explicit
monotone validity checks to absorb any float rounding of the log estimate.

Process choice per pair (reference ``_collision_coalescence_breakup_body``):
bounce if ``rand > Ec + (1-Ec)*Eb``; coalesce if ``rand < Ec``; else break up.

Divergences from the reference (documented, both are reference bug-guards):
- ``break_up_while`` (handle_all_breakups=True) in the reference spins forever
  if the closed-form transfer yields zero events without overflow; here the
  pair is deactivated and the remaining gamma goes to the deficit counter.
- the reference's equal-multiplicity overflow branch double-counts the deficit
  (adds before ``break`` and again after the loop); here it is added once.
"""

import jax
import jax.numpy as jnp

from .collisions import (
    accumulate_counter,
    coalesce,
    _cell_start_of,
    _pairing_or_adjacent,
)

_F64 = jnp.float64


def fragmentation_limiters(fragment_mass, mass_sum, *, vmin_mass=0.0, nfmax=None):
    """reference ``fragmentation_methods.py:_fragmentation_limiters_body``:
    NaN/zero fragment -> whole mass (no breakup); fragment <= total;
    at most nfmax fragments; fragments below vmin -> whole mass."""
    fm = jnp.where(
        jnp.isnan(fragment_mass) | (fragment_mass <= 0.0), mass_sum, fragment_mass
    )
    fm = jnp.minimum(fm, mass_sum)
    if nfmax is not None:
        fm_capped = jnp.maximum(fm, mass_sum / nfmax)
        too_many = mass_sum / fm > nfmax
    else:
        fm_capped = fm
        too_many = jnp.zeros(fm.shape, dtype=bool)
    fm = jnp.where(too_many, fm_capped, jnp.where(fm < vmin_mass, mass_sum, fm))
    return jnp.where(mass_sum <= 0.0, jnp.ones_like(fm), fm)


def _transfer_closed_form(gamma_f, mult_j, mult_k, mass_j, mass_k, fm, max_mult):
    """closed form of reference ``compute_transfer_multiplicities``; all float64.
    Returns (take_from_j, new_mult_k, gamma_j_k, overflow)."""
    fm = jnp.maximum(fm, jnp.finfo(_F64).tiny)
    alpha = (mass_j + mass_k) / fm
    beta = mass_j / fm
    beta_pos = beta > 0.0
    beta_safe = jnp.where(beta_pos, beta, 1.0)
    log1pb = jnp.log1p(beta_safe)
    mk = mult_k
    alpha_safe = jnp.maximum(alpha, jnp.finfo(_F64).tiny)

    def pair_values(g):
        """(new_mult_k, take_from_j) accepted at gamma_j_k = g (g >= 1)"""
        p = jnp.exp((g - 1.0) * log1pb)  # (1+beta)^(g-1)
        nmk = mk * alpha * p
        tfj = jnp.where(
            beta_pos,
            mk * (1.0 + alpha * (p - 1.0) / beta_safe),
            mk * (1.0 + (g - 1.0) * alpha),
        )
        return nmk, tfj

    def valid(g):
        nmk, tfj = pair_values(g)
        return (g >= 1.0) & (g <= gamma_f) & (nmk <= max_mult) & (tfj <= mult_j)

    # log-estimates of the two monotone constraints' break points
    g1 = jnp.floor(jnp.log(max_mult / (mk * alpha_safe)) / log1pb) + 1.0
    rhs2 = 1.0 + beta_safe * (mult_j / mk - 1.0) / alpha_safe
    g2 = jnp.where(
        beta_pos,
        jnp.floor(jnp.log(jnp.maximum(rhs2, 1.0)) / log1pb) + 1.0,
        jnp.floor((mult_j / mk - 1.0) / alpha_safe) + 1.0,
    )
    g = jnp.clip(jnp.minimum(jnp.minimum(g1, g2), gamma_f), 0.0, gamma_f)
    g = jnp.where(jnp.isnan(g), 0.0, g)
    for _ in range(2):  # absorb log rounding: push up while still valid
        g = jnp.where(valid(g + 1.0), g + 1.0, g)
    for _ in range(2):  # ...and down while invalid
        g = jnp.where(valid(g) | (g <= 0.0), g, g - 1.0)
    g = jnp.maximum(g, 0.0)

    nmk_g, tfj_g = pair_values(jnp.maximum(g, 1.0))
    take_from_j = jnp.where(g >= 1.0, tfj_g, 0.0)
    new_mult_k = jnp.where(g >= 1.0, nmk_g, mk)
    nmk_next, _ = pair_values(g + 1.0)
    overflow = (g < gamma_f) & (nmk_next > max_mult)
    return take_from_j, new_mult_k, g, overflow


def _apply_breakup_update(mj, mk, ej, ek, take, new_mult_k):
    """reference ``get_new_multiplicities_and_update_attributes`` +
    ``round_multiplicities_to_ints_and_update_attributes``: redistribute
    attributes over the fragments, split j if fully consumed, round
    multiplicities to >=1 ints rescaling attributes to conserve totals."""
    ek_mix = (ek * mk[None, :] + take[None, :] * ej) / new_mult_k[None, :]
    deplete = take >= mj
    nj = jnp.where(deplete, new_mult_k / 2.0, mj - take)
    nk = jnp.where(deplete, new_mult_k / 2.0, new_mult_k)
    ej_mix = jnp.where(deplete[None, :], ek_mix, ej)
    mj_new = jnp.maximum(jnp.round(nj), 1.0)
    mk_new = jnp.maximum(jnp.round(nk), 1.0)
    ej_out = ej_mix * (nj / mj_new)[None, :]
    ek_out = ek_mix * (nk / mk_new)[None, :]
    return mj_new, mk_new, ej_out, ek_out


def collision_coalescence_breakup(
    *,
    mult_s,
    ext_s,
    ext_names,
    gamma,
    rand,
    Ec,
    Eb,
    fragment_mass,
    is_first,
    sorted_cell,
    n_cell,
    counters,
    max_multiplicity,
    handle_all_breakups,
    formulae,
    cell_start=None,
    pairing=None,
):
    """fused bounce/coalesce/breakup update over sorted slots; returns
    (mult_s, ext_s, counters). Pair convention from ``pairing`` (defaults to
    the sort-croupier adjacency: slot p pairs with p+1 where ``is_first[p]``;
    the mirror croupier passes ``ops.pairing.MirrorPairing``)."""
    pairing = _pairing_or_adjacent(pairing, is_first)
    ftype = ext_s.dtype
    mult_dtype = mult_s.dtype
    active = is_first & (gamma > 0)
    bouncing = rand - (Ec + (1.0 - Ec) * Eb) > 0.0
    do_coal = active & ~bouncing & (rand - Ec < 0.0)
    do_break = active & ~bouncing & ~do_coal

    # --- coalescing pairs: reuse the pure-coalescence update --------------
    if cell_start is None and sorted_cell is not None:
        cell_start = _cell_start_of(sorted_cell, n_cell)
    gamma_c = jnp.where(do_coal, gamma, jnp.zeros((), gamma.dtype))
    mult_s, ext_s, counters = coalesce(
        mult_s, ext_s, gamma_c, do_coal, sorted_cell, n_cell, counters,
        cell_start=cell_start, pairing=pairing,
    )

    # --- breaking pairs ----------------------------------------------------
    wm_idx = ext_names.index("signed water mass")
    a_m = mult_s.astype(_F64)
    b_m = pairing.partner(mult_s).astype(_F64)
    a_e = ext_s.astype(_F64)
    b_e = pairing.partner(ext_s, axis=1).astype(_F64)
    gamma_f = jnp.where(do_break, gamma, 0).astype(_F64)
    mass_sum_pair = jnp.abs(a_e[wm_idx]) + jnp.abs(b_e[wm_idx])
    fm = fragmentation_limiters(fragment_mass.astype(_F64), mass_sum_pair)
    max_mult = jnp.asarray(float(max_multiplicity), _F64)

    if not handle_all_breakups:
        j_is_a = a_m >= b_m
        mj = jnp.where(j_is_a, a_m, b_m)
        mk = jnp.where(j_is_a, b_m, a_m)
        ej = jnp.where(j_is_a[None, :], a_e, b_e)
        ek = jnp.where(j_is_a[None, :], b_e, a_e)
        mass_j = jnp.abs(ej[wm_idx])
        mass_k = jnp.abs(ek[wm_idx])

        take, new_mult_k, gjk, _overflow = _transfer_closed_form(
            gamma_f, mj, jnp.maximum(mk, 1.0), mass_j, mass_k, fm, max_mult
        )
        mj_new, mk_new, ej_new, ek_new = _apply_breakup_update(
            mj, mk, ej, ek, take, new_mult_k
        )
        rate = jnp.where(do_break, gjk * mk, 0.0)
        deficit = jnp.where(do_break, (gamma_f - gjk) * mk, 0.0)
    else:
        # reference ``break_up_while``: keep transferring until gamma spent,
        # swapping j/k roles as multiplicities evolve
        def cond(carry):
            return jnp.any(carry["act"])

        def body(carry):
            m_a, m_b = carry["m_a"], carry["m_b"]
            e_a, e_b = carry["e_a"], carry["e_b"]
            act = carry["act"]
            deficit = carry["deficit"]
            j_is_a = m_a >= m_b
            mj = jnp.where(j_is_a, m_a, m_b)
            mk = jnp.where(j_is_a, m_b, m_a)
            ej = jnp.where(j_is_a[None, :], e_a, e_b)
            ek = jnp.where(j_is_a[None, :], e_b, e_a)
            mass_j = jnp.abs(ej[wm_idx])
            mass_k = jnp.abs(ek[wm_idx])

            eq = mj == mk
            # equal-multiplicity branch: consume the whole deficit at once
            nmk_eq = (mass_j + mass_k) / jnp.maximum(fm, jnp.finfo(_F64).tiny) * mk
            eq_overflow = nmk_eq > max_mult
            take_n, nmk_n, gjk_n, _ovf = _transfer_closed_form(
                deficit, mj, jnp.maximum(mk, 1.0), mass_j, mass_k, fm, max_mult
            )
            take = jnp.where(eq, mj, take_n)
            nmk = jnp.where(eq, nmk_eq, nmk_n)
            gjk = jnp.where(eq, deficit, gjk_n)
            # pairs making no progress (first-event overflow or eq-overflow)
            stalled = act & (eq & eq_overflow | ~eq & (gjk_n <= 0.0))
            doing = act & ~stalled
            gjk = jnp.where(doing, gjk, 0.0)
            take = jnp.where(doing, take, 0.0)
            nmk = jnp.where(doing, nmk, mk)

            mj_new, mk_new, ej_new, ek_new = _apply_breakup_update(
                mj, mk, ej, ek, take, nmk
            )
            mj_new = jnp.where(doing, mj_new, mj)
            mk_new = jnp.where(doing, mk_new, mk)
            ej_new = jnp.where(doing[None, :], ej_new, ej)
            ek_new = jnp.where(doing[None, :], ek_new, ek)

            rate = carry["rate"] + jnp.where(doing, gjk * mk, 0.0)
            deficit_new = jnp.where(doing, deficit - gjk, deficit)
            defacc = carry["defacc"] + jnp.where(stalled, deficit * mk, 0.0)
            act = doing & (deficit_new > 0.0)
            return {
                "m_a": jnp.where(j_is_a, mj_new, mk_new),
                "m_b": jnp.where(j_is_a, mk_new, mj_new),
                "e_a": jnp.where(j_is_a[None, :], ej_new, ek_new),
                "e_b": jnp.where(j_is_a[None, :], ek_new, ej_new),
                "act": act,
                "deficit": deficit_new,
                "rate": rate,
                "defacc": defacc,
            }

        out = jax.lax.while_loop(
            cond,
            body,
            {
                "m_a": a_m,
                "m_b": b_m,
                "e_a": a_e,
                "e_b": b_e,
                "act": do_break,
                "deficit": gamma_f,
                "rate": jnp.zeros_like(gamma_f),
                "defacc": jnp.zeros_like(gamma_f),
            },
        )
        rate = out["rate"]
        deficit = out["defacc"]
        # slot results are already in a/b roles
        j_is_a = jnp.ones_like(do_break)  # identity mapping below
        mj_new, mk_new = out["m_a"], out["m_b"]
        ej_new, ek_new = out["e_a"], out["e_b"]

    if not handle_all_breakups:
        a_m_new = jnp.where(j_is_a, mj_new, mk_new)
        b_m_new = jnp.where(j_is_a, mk_new, mj_new)
        a_e_new = jnp.where(j_is_a[None, :], ej_new, ek_new)
        b_e_new = jnp.where(j_is_a[None, :], ek_new, ej_new)
    else:
        a_m_new, b_m_new = mj_new, mk_new
        a_e_new, b_e_new = ej_new, ek_new

    mult_out = pairing.merge(
        mult_s,
        jnp.round(a_m_new).astype(mult_dtype),
        jnp.round(b_m_new).astype(mult_dtype),
        do_break,
    )
    ext_out = pairing.merge(
        ext_s, a_e_new.astype(ftype), b_e_new.astype(ftype), do_break, axis=1
    )

    if counters is not None:
        counters["breakup_rate"] = accumulate_counter(
            counters["breakup_rate"], rate, cell_start, n_cell,
            counters=counters,
        )
        counters["breakup_rate_deficit"] = accumulate_counter(
            counters["breakup_rate_deficit"], deficit, cell_start, n_cell,
            counters=counters,
        )
    return mult_out, ext_out, counters
