"""Vectorized SDM collision ops (Shima et al. 2009).

Semantics-parity with the reference CPU kernels
(``PySDM/backends/impl_numba/methods/collisions_methods.py``), re-expressed as
branch-free vectorized updates over sorted particle slots:

- pairs are disjoint (slots (p, p+1) where ``is_first_in_pair[p]``), so the
  coalescence update is a gather -> compute -> permutation-scatter with no
  atomics; rate counters use deterministic segment sums instead of atomic adds
  (SURVEY.md §7 delta #4);
- per-pair quantities are computed at every sorted slot p (with p+1 as the
  partner) and masked by ``is_first_in_pair`` — redundant lanes cost less
  than the reference's pair-compaction bookkeeping.

Conventions: within a pair, ``j`` is the particle with the not-smaller
multiplicity, ``k`` the other (reference ``pair_methods.py:127-140``).

Multiplicity dtype policy: multiplicities may be stored as int64 (bit-exact
vs the reference) or as float64 (exact for integers < 2^53 — far above the
reference's own multiplicity cap of 2^63/2e5 ~ 4.6e13, reference
``collision.py:30-37``); the f64 path needs an exactly-corrected floor
division (``floor_div`` below).
"""

import jax.numpy as jnp

from .pairing import AdjacentPairing
from .segments import (
    cell_counts,
    pair_roll,
    sorted_segment_min,
    sorted_segment_sum,
)


def _pairing_or_adjacent(pairing, is_first):
    """ops below accept an optional ``ops.pairing`` matching object; the
    default is the sort-croupier adjacency convention (slot p pairs p+1)"""
    return pairing if pairing is not None else AdjacentPairing(is_first)


def floor_div(a, b):
    """exact floor(a/b) for non-negative integers stored in either an integer
    dtype or a float dtype (exact while values < 2^mantissa): float division
    rounds to nearest, so the raw quotient may be off by one — two
    multiply-compare correction steps make it exact."""
    if jnp.issubdtype(a.dtype, jnp.integer):
        return a // b
    q = jnp.floor(a / b)
    q = jnp.where(q * b > a, q - 1.0, q)
    q = jnp.where((q + 1.0) * b <= a, q + 1.0, q)
    return q


def capped_floor_div(a, b, cap_f):
    """exact min(cap, floor(a/b)) for non-negative int64 a, b>0 and an
    integral f32 cap, without a 64-bit division: start from the f32
    quotient estimate, clamp by the cap,
    then walk to the exact answer with i64 multiply-compare steps. The f32
    estimate is within +-5 of floor(a/b) whenever the result matters (result
    <= cap <= 2^24, the exact-integer range of the f32 pipeline that produced
    the cap; for larger quotients the cap always binds and is returned
    directly). Returns a's dtype."""
    if not jnp.issubdtype(a.dtype, jnp.integer):
        q = floor_div(a, b)
        return jnp.minimum(q, cap_f.astype(q.dtype))
    af = a.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    q_est = jnp.floor(af / bf)
    g = jnp.minimum(q_est, cap_f).astype(a.dtype)
    g = jnp.maximum(g, jnp.zeros((), a.dtype))
    cap_i = cap_f.astype(a.dtype)
    for _ in range(5):  # f32 rel. error 2^-23 * 2^24 < 2 -> 5 covers margin
        g = jnp.where(g * b > a, g - 1, g)
    for _ in range(5):
        g = jnp.where(((g + 1) * b <= a) & (g + 1 <= cap_i), g + 1, g)
    return g


def half_floor(m):
    """floor(m/2) in m's dtype (exact: division by two is lossless in floats)"""
    if jnp.issubdtype(m.dtype, jnp.integer):
        return m // 2
    return jnp.floor(m * 0.5)


def normalization_factor(cell_start, dt, dv, n_cell, dtype):
    """Shima eq. 20 norm factor per cell: dt/dv * n(n-1)/2 / floor(n/2)
    (reference ``collisions_methods.py:634-650``)"""
    sd_num = cell_counts(cell_start).astype(dtype)
    dv = jnp.asarray(dv, dtype=dtype)
    factor = dt / dv * sd_num * (sd_num - 1) / 2 / jnp.floor(sd_num / 2)
    return jnp.where(sd_num < 2, jnp.zeros((), dtype), factor)


def mirror_normalization_factor(dt, dv, n_sd, dtype):
    """normalization for the sort-free mirror croupier (single cell):
    every unordered pair is a candidate with probability exactly 1/N, so the
    Shima scaling 1/P(candidate) is just N (``ops.pairing.MirrorPairing``)"""
    return jnp.full((1,), dt / dv * n_sd, dtype=dtype)


def collision_probability(
    kernel_values, mult_s, sorted_cell, norm_factor, is_first, pairing=None
):
    """prob[p] = max(xi_p, xi_partner) * K * norm_factor[cell]"""
    pairing = _pairing_or_adjacent(pairing, is_first)
    max_mult = jnp.maximum(mult_s, pairing.partner(mult_s)).astype(
        kernel_values.dtype
    )
    if sorted_cell is None:  # single-cell (mirror) path
        norm_b = norm_factor[0]
    else:
        norm = jnp.concatenate([norm_factor, jnp.zeros((1,), norm_factor.dtype)])
        norm_b = norm[sorted_cell]
    prob = max_mult * kernel_values * norm_b
    return jnp.where(is_first, prob, 0.0)


def scale_prob_adaptive(
    *, prob, mult_s, sorted_cell, cell_start, is_first, dt_left, dt, dt_range,
    n_cell, stats_n_substep=None, stats_dt_min=None, pairing=None,
):
    """per-cell adaptive substep scaling
    (reference ``collisions_methods.py:330-378``): pick the largest per-cell
    substep dt_todo <= min(dt_left, dt_max) that keeps every pair's expected
    collision count ~<= multiplicity ratio, scale prob accordingly, and
    decrement dt_left."""
    ftype = prob.dtype
    pairing = _pairing_or_adjacent(pairing, is_first)
    mult_p = pairing.partner(mult_s)
    mj = jnp.maximum(mult_s, mult_p)
    mk = jnp.minimum(mult_s, mult_p)
    # prop only feeds the f32 pacing heuristic dt_optimal below, so the
    # i64 floor division is replaced by its f32 image; differs from exact
    # floor only at ULP knife-edges that perturb dt_todo by O(1e-7) relative
    if jnp.issubdtype(mj.dtype, jnp.integer):
        prop = jnp.floor(
            mj.astype(ftype) / jnp.maximum(mk, 1).astype(ftype)
        )
    else:
        prop = floor_div(
            mj, jnp.maximum(mk, jnp.ones((), mk.dtype))
        ).astype(ftype)
    dt_optimal = dt * prop / jnp.where(prob > 0, prob, 1.0)
    dt_optimal = jnp.maximum(dt_optimal, dt_range[0])
    dt_optimal = jnp.where(is_first & (prob > 0), dt_optimal, jnp.inf)

    dt_todo = jnp.minimum(dt_left, dt_range[1])
    if sorted_cell is None:  # single-cell (mirror) path: plain masked min
        per_cell_opt = jnp.min(dt_optimal)[None]
    else:
        per_cell_opt = sorted_segment_min(
            dt_optimal, sorted_cell, cell_start, n_cell
        )
    dt_todo = jnp.minimum(dt_todo, per_cell_opt)

    if sorted_cell is None:
        prob = prob * dt_todo[0] / dt
    else:
        dt_todo_ext = jnp.concatenate([dt_todo, jnp.zeros((1,), ftype)])
        prob = prob * dt_todo_ext[sorted_cell] / dt
    new_dt_left = dt_left - dt_todo
    if stats_n_substep is not None:
        stats_n_substep = stats_n_substep + (dt_todo > 0)
    if stats_dt_min is not None:
        stats_dt_min = jnp.minimum(
            stats_dt_min, jnp.where(jnp.isinf(per_cell_opt), stats_dt_min, per_cell_opt)
        )
    return prob, new_dt_left, stats_n_substep, stats_dt_min


def _cell_start_of(sorted_cell, n_cell):
    return jnp.searchsorted(
        sorted_cell, jnp.arange(n_cell + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)


def accumulate_counter(counter, values, cell_start, n_cell, counters=None):
    """add per-cell sums of ``values`` to a rate counter. The sum runs in
    float32 regardless of the counter dtype: rate counters are
    diagnostics (exact below 2^24 events per readout; ~1e-7 relative beyond —
    the reference accumulates exactly via int64 atomics,
    ``collisions_methods.py:523-560``). When the ``counters`` dict carries a
    ``rate_step_sum_max`` slot, the largest per-step per-cell sum is recorded
    there so readouts can flag precision loss (sums past 2^24 are no longer
    f32-exact). ``cell_start=None`` selects the single-cell (mirror-croupier)
    path: a plain masked global sum, no cumsum."""
    if cell_start is None:
        assert n_cell == 1
        s = jnp.sum(values.astype(jnp.float32))[None]
    else:
        s = sorted_segment_sum(values.astype(jnp.float32), cell_start, n_cell)
    if counters is not None and "rate_step_sum_max" in counters:
        counters["rate_step_sum_max"] = jnp.maximum(
            counters["rate_step_sum_max"], s.max()
        )
    if jnp.issubdtype(counter.dtype, jnp.integer):
        return counter + jnp.round(s).astype(counter.dtype)
    return counter + s.astype(counter.dtype)


def compute_gamma(
    prob, rand, mult_s, sorted_cell, is_first, n_cell, counters=None,
    cell_start=None, pairing=None,
):
    """gamma = ceil(prob - rand), capped at floor(xi_j/xi_k)
    (reference ``collisions_methods.py:522-560``); returns integer gamma per
    slot and updates collision_rate / collision_rate_deficit counters."""
    pairing = _pairing_or_adjacent(pairing, is_first)
    mult_dtype = mult_s.dtype
    gamma_f = jnp.maximum(jnp.ceil(prob - rand), 0.0)
    gamma_f = jnp.where(is_first, gamma_f, 0.0)
    mult_p = pairing.partner(mult_s)
    mj = jnp.maximum(mult_s, mult_p)
    mk = jnp.minimum(mult_s, mult_p)
    # gamma = min(ceil(prob-rand), floor(mj/mk)) without the emulated i64
    # division: exact via f32 estimate + multiply-compare walk
    gamma = capped_floor_div(
        mj, jnp.maximum(mk, jnp.ones((), mk.dtype)), gamma_f
    ).astype(mult_dtype)
    gamma = jnp.where(is_first, gamma, jnp.zeros((), mult_dtype))
    if counters is not None:
        if cell_start is None and sorted_cell is not None:
            cell_start = _cell_start_of(sorted_cell, n_cell)
        rate = gamma.astype(jnp.float32) * mk.astype(jnp.float32)
        deficit = (gamma_f - gamma.astype(gamma_f.dtype)) * mk.astype(gamma_f.dtype)
        counters["collision_rate"] = accumulate_counter(
            counters["collision_rate"],
            jnp.where(is_first, rate, 0.0),
            cell_start,
            n_cell,
            counters=counters,
        )
        counters["collision_rate_deficit"] = accumulate_counter(
            counters["collision_rate_deficit"],
            jnp.where(is_first, deficit, 0.0),
            cell_start,
            n_cell,
            counters=counters,
        )
    return gamma, counters


def coalesce(
    mult_s, ext_s, gamma, is_first, sorted_cell, n_cell, counters=None,
    cell_start=None, max_s=None, pairing=None,
):
    """Shima 2009 coalescence update (reference ``collisions_methods.py:45-59``):
    xi_j -= gamma * xi_k and extensive_k += gamma * extensive_j; when xi_j
    hits 0 the j-droplet is recycled by splitting k's multiplicity in half.
    Maximum attributes (``max_s``, e.g. freezing temperature) take the
    pairwise max on merge — semantics the reference declares
    (``attributes/impl/maximum_attribute.py``) but leaves unwired in its
    coalescence kernel (``impl/particle_attributes_factory.py:118``,
    TODO #594). Returns updated (mult_s, ext_s[, max_s]) in sorted-slot
    order."""
    pairing = _pairing_or_adjacent(pairing, is_first)
    ftype = ext_s.dtype
    a_m, b_m = mult_s, pairing.partner(mult_s)
    a_e, b_e = ext_s, pairing.partner(ext_s, axis=1)

    j_is_a = a_m >= b_m
    mj = jnp.where(j_is_a, a_m, b_m)
    mk = jnp.where(j_is_a, b_m, a_m)
    ej = jnp.where(j_is_a[None, :], a_e, b_e)
    ek = jnp.where(j_is_a[None, :], b_e, a_e)

    g = jnp.where(is_first, gamma, jnp.zeros((), gamma.dtype))
    gf = g.astype(ftype)
    new_n = mj - g * mk
    split = is_first & (new_n == 0) & (g > 0)

    mk_half = half_floor(mk)
    mj_new = jnp.where(split, mk_half, new_n)
    mk_new = jnp.where(split, mk - mk_half, mk)
    # attributes: normal case k absorbs g copies of j; split case both equal
    ek_merged = ek + gf[None, :] * ej
    ej_new = jnp.where(split[None, :], ek_merged, ej)
    ek_new = ek_merged  # in non-split case this is the coalesce rule already

    if counters is not None:
        if cell_start is None and sorted_cell is not None:
            cell_start = _cell_start_of(sorted_cell, n_cell)
        coal = jnp.where(
            is_first, g.astype(jnp.float32) * mk.astype(jnp.float32), 0.0
        )
        counters["coalescence_rate"] = accumulate_counter(
            counters["coalescence_rate"], coal, cell_start, n_cell,
            counters=counters,
        )

    # map (j, k) results back to slots (p, p+1)
    a_m_new = jnp.where(j_is_a, mj_new, mk_new)
    b_m_new = jnp.where(j_is_a, mk_new, mj_new)
    a_e_new = jnp.where(j_is_a[None, :], ej_new, ek_new)
    b_e_new = jnp.where(j_is_a[None, :], ek_new, ej_new)

    mult_out = pairing.merge(mult_s, a_m_new, b_m_new, is_first)
    ext_out = pairing.merge(ext_s, a_e_new, b_e_new, is_first, axis=1)
    if max_s is None or max_s.shape[0] == 0:
        return mult_out, ext_out, counters

    a_x, b_x = max_s, pairing.partner(max_s, axis=1)
    xj = jnp.where(j_is_a[None, :], a_x, b_x)
    xk = jnp.where(j_is_a[None, :], b_x, a_x)
    # fmax, not maximum: NaN marks "not recorded" for rows like temperature
    # of last freezing / cooling-rate prev-T — an unrecorded partner must not
    # poison the survivor's value
    merged_x = jnp.fmax(xj, xk)
    # droplets that absorbed anything (g>0) take the pair max; in the split
    # case both halves descend from the same merged droplet
    collided = (g > 0)[None, :]
    xk_new = jnp.where(collided, merged_x, xk)
    xj_new = jnp.where(split[None, :], merged_x, xj)
    a_x_new = jnp.where(j_is_a[None, :], xj_new, xk_new)
    b_x_new = jnp.where(j_is_a[None, :], xk_new, xj_new)
    max_out = pairing.merge(max_s, a_x_new, b_x_new, is_first, axis=1)
    return mult_out, ext_out, counters, max_out


def _merge_pair_results(orig, a_new, b_new, is_first, axis=0):
    """slot p gets a_new[p] if it leads a pair, b_new[p-1] if it trails one"""
    is_first_prev = jnp.roll(is_first, 1)
    b_from_prev = jnp.roll(b_new, 1, axis=axis)
    if axis == 0:
        return jnp.where(is_first, a_new, jnp.where(is_first_prev, b_from_prev, orig))
    mask_f = is_first[None, :]
    mask_p = is_first_prev[None, :]
    return jnp.where(mask_f, a_new, jnp.where(mask_p, b_from_prev, orig))
