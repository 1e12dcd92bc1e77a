"""MPDATA Eulerian advection in JAX (N-dimensional, Arakawa-C staggered grid).

The reference outsources Eulerian advection to the external Numba-based
PyMPDATA package (used via ``examples/.../mpdata_1d.py`` and ``mpdata_2d.py``);
here the advector is first-class: the whole multi-pass MPDATA
step is pure jnp (static shapes, no halo bookkeeping objects) so XLA fuses the
upwind/antidiffusion/FCT passes and the step can run inside the jitted
simulation step and under ``shard_map`` (halo exchange = the same pads with
``ppermute`` collectives).

Algorithm: Smolarkiewicz & Margolin 1998 (J. Comp. Phys. 140) / the
libmpdata++ formulation (Jaruga et al. 2015, GMD 8) with the option surface
the reference's examples use (``mpdata_1d.py:26-31``, ``mpdata_2d.py:45-50``):
``n_iters``, ``infinite_gauge``, ``nonoscillatory`` (FCT), non-unit g-factor
(G = rhod), periodic & extrapolated boundary conditions. Conventions:

- cell field ``psi``: shape ``grid``;
- advector ``gc[d]`` = G * courant at faces: shape ``grid`` with ``+1`` along
  axis ``d`` (boundary faces included);
- g-factor ``g``: shape ``grid`` (or None for G = 1).
"""

import jax.numpy as jnp

PERIODIC = "periodic"
EXTRAPOLATED = "extrapolated"  # constant (zero-gradient) scalar extrapolation


def _eps(dtype):
    return jnp.asarray(1e-15 if jnp.finfo(dtype).bits == 64 else 1e-7, dtype)


def _pad1(arr, axis, bc, depth=1):
    """halo-``depth`` pad along one axis; a ``('shard', axis_name)`` bc pads
    with the neighbouring shards' boundary slices via ppermute
    (parallel.halo) — globally-periodic semantics under shard_map"""
    if isinstance(bc, tuple) and bc[0] == "shard":
        from ..parallel.halo import ring_halo_pad

        return ring_halo_pad(arr, axis, bc[1], depth=depth)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (depth, depth)
    return jnp.pad(arr, pad, mode="wrap" if bc == PERIODIC else "edge")


def _pad_all(psi, bcs, depth=1):
    for ax, bc in enumerate(bcs):
        psi = _pad1(psi, ax, bc, depth=depth)
    return psi


def _face_view(psi_p, d, side, shifts=()):
    """cell values adjacent to the n_d+1 faces along axis d, from the
    everywhere-padded field; side 0 = left cell, 1 = right cell; ``shifts``
    optionally offsets other axes by -1/0/+1 (for cross-derivative stencils)"""
    shifts = dict(shifts)
    idx = []
    for ax in range(psi_p.ndim):
        if ax == d:
            idx.append(slice(side, psi_p.shape[ax] - 1 + side))
        else:
            s = shifts.get(ax, 0)
            idx.append(slice(1 + s, psi_p.shape[ax] - 1 + s))
    return psi_p[tuple(idx)]


def _face_view_deep(psi_p2, d, offset, shifts=()):
    """cell values at relative position ``offset`` w.r.t. the n_d+1 faces
    along axis d (0 = left cell, 1 = right cell, +2/-1 = next-nearest),
    from the everywhere-halo-2-padded field"""
    shifts = dict(shifts)
    idx = []
    for ax in range(psi_p2.ndim):
        if ax == d:
            idx.append(slice(1 + offset, psi_p2.shape[ax] - 2 + offset))
        else:
            s = shifts.get(ax, 0)
            idx.append(slice(2 + s, psi_p2.shape[ax] - 2 + s))
    return psi_p2[tuple(idx)]


def _flux_divergence(fluxes, psi_shape):
    div = 0.0
    for d, flx in enumerate(fluxes):
        idx_hi = [slice(None)] * len(psi_shape)
        idx_lo = [slice(None)] * len(psi_shape)
        idx_hi[d] = slice(1, None)
        idx_lo[d] = slice(0, -1)
        div = div + (flx[tuple(idx_hi)] - flx[tuple(idx_lo)])
    return div


def _upwind_fluxes(psi_p, gc, bcs):
    fluxes = []
    for d, gc_d in enumerate(gc):
        psi_l = _face_view(psi_p, d, 0)
        psi_r = _face_view(psi_p, d, 1)
        fluxes.append(
            jnp.maximum(gc_d, 0.0) * psi_l + jnp.minimum(gc_d, 0.0) * psi_r
        )
    return fluxes


def _frac(num, den, dtype):
    return num / (den + _eps(dtype))


def _gc_bar(gc_q, d, q, bcs):
    """average of the 4 q-faces around each d-face"""
    gp = _pad1(gc_q, d, bcs[d])

    def sl(d_off, q_off):
        idx = []
        for ax in range(gp.ndim):
            if ax == d:
                idx.append(slice(d_off, gp.shape[ax] - 1 + d_off))
            elif ax == q:
                idx.append(slice(q_off, gp.shape[ax] - 2 + q_off + 1))
            else:
                idx.append(slice(None))
        return gp[tuple(idx)]

    return 0.25 * (sl(0, 0) + sl(0, 1) + sl(1, 0) + sl(1, 1))


def _g_at_faces(g, d, bc):
    gp = _pad1(g, d, bc)
    idx_l = [slice(None)] * gp.ndim
    idx_r = [slice(None)] * gp.ndim
    idx_l[d] = slice(0, -1)
    idx_r[d] = slice(1, None)
    return 0.5 * (gp[tuple(idx_l)] + gp[tuple(idx_r)])


def _antidiffusive_gc(psi, gc, g, bcs, infinite_gauge, third_order_terms=False):
    """pseudo-velocity GC' per SM98 eq. 13 generalised to non-unit G
    (libmpdata++ eq. 29-32): |GC|(1-|GC|/Gbar)*A - GC * sum_q GCbar_q/Gbar * B_q;
    with ``third_order_terms`` the SM98 eq. 36 corrections are added (the
    option surface the reference's examples pass to PyMPDATA,
    ``mpdata_2d.py:45-50`` third_order_terms=...)"""
    dtype = psi.dtype
    ndim = psi.ndim
    psi_p = _pad_all(psi, bcs)
    psi_p2 = _pad_all(psi, bcs, depth=2) if third_order_terms else None
    gc_out = []
    for d, gc_d in enumerate(gc):
        psi_l = _face_view(psi_p, d, 0)
        psi_r = _face_view(psi_p, d, 1)
        if infinite_gauge:
            a_term = 0.5 * (psi_r - psi_l)
        else:
            a_term = _frac(
                jnp.abs(psi_r) - jnp.abs(psi_l),
                jnp.abs(psi_r) + jnp.abs(psi_l),
                dtype,
            )
        g_bar = (
            _g_at_faces(g, d, bcs[d])
            if g is not None
            else jnp.ones_like(gc_d)
        )
        out = (jnp.abs(gc_d) - gc_d**2 / g_bar) * a_term
        for q in range(ndim):
            if q == d:
                continue
            lu = _face_view(psi_p, d, 0, {q: +1})
            ru = _face_view(psi_p, d, 1, {q: +1})
            ld = _face_view(psi_p, d, 0, {q: -1})
            rd = _face_view(psi_p, d, 1, {q: -1})
            if infinite_gauge:
                b_term = 0.5 * (lu + ru - ld - rd) / 4.0
            else:
                b_term = 0.5 * _frac(
                    jnp.abs(lu) + jnp.abs(ru) - jnp.abs(ld) - jnp.abs(rd),
                    jnp.abs(lu) + jnp.abs(ru) + jnp.abs(ld) + jnp.abs(rd),
                    dtype,
                )
            out = out - gc_d * _gc_bar(gc[q], d, q, bcs) / g_bar * b_term

        if third_order_terms:
            # own-dimension term, SM98 eq. 36: coefficient
            # (3 GC |GC|/G - 2 GC^3/G^2 - GC)/6 times the normalized
            # second difference across the face (-> a psi_xxx flux term)
            p2 = _face_view_deep(psi_p2, d, 2)
            p1 = _face_view_deep(psi_p2, d, 1)
            p0 = _face_view_deep(psi_p2, d, 0)
            pm = _face_view_deep(psi_p2, d, -1)
            coef = (
                3.0 * gc_d * jnp.abs(gc_d) / g_bar
                - 2.0 * gc_d**3 / g_bar**2
                - gc_d
            ) / 6.0
            if infinite_gauge:
                tot = coef * (p2 - p1 - p0 + pm) / 2.0
            else:
                tot = coef * 2.0 * _frac(
                    jnp.abs(p2) - jnp.abs(p1) - jnp.abs(p0) + jnp.abs(pm),
                    jnp.abs(p2) + jnp.abs(p1) + jnp.abs(p0) + jnp.abs(pm),
                    dtype,
                )
            out = out + tot
            # cross term: GCbar_q/(2G) (|GC| - 2 GC^2/G) times the
            # normalized mixed difference
            for q in range(ndim):
                if q == d:
                    continue
                lu = _face_view(psi_p, d, 0, {q: +1})
                ru = _face_view(psi_p, d, 1, {q: +1})
                ld = _face_view(psi_p, d, 0, {q: -1})
                rd = _face_view(psi_p, d, 1, {q: -1})
                coef_x = (
                    _gc_bar(gc[q], d, q, bcs)
                    / (2.0 * g_bar)
                    * (jnp.abs(gc_d) - 2.0 * gc_d**2 / g_bar)
                )
                if infinite_gauge:
                    tot_x = coef_x * (ru - lu - rd + ld) / 2.0
                else:
                    tot_x = coef_x * 2.0 * _frac(
                        jnp.abs(ru) - jnp.abs(lu) - jnp.abs(rd) + jnp.abs(ld),
                        jnp.abs(ru) + jnp.abs(lu) + jnp.abs(rd) + jnp.abs(ld),
                        dtype,
                    )
                out = out + tot_x
        gc_out.append(out)
    return gc_out


def _local_extrema(psi_p, psi0_p, d_axes, reduce_fn):
    """per-cell extremum over the cell and its face neighbours along every
    axis, for both the initial and the current iterate"""
    ext = None
    for arr in (psi_p, psi0_p):
        centre_idx = tuple(slice(1, s - 1) for s in arr.shape)
        vals = [arr[centre_idx]]
        for d in d_axes:
            lo = tuple(
                slice(0, s - 2) if ax == d else slice(1, s - 1)
                for ax, s in enumerate(arr.shape)
            )
            hi = tuple(
                slice(2, s) if ax == d else slice(1, s - 1)
                for ax, s in enumerate(arr.shape)
            )
            vals += [arr[lo], arr[hi]]
        cand = vals[0]
        for v in vals[1:]:
            cand = reduce_fn(cand, v)
        ext = cand if ext is None else reduce_fn(ext, cand)
    return ext


def _fct_limit(psi, psi0, gc_corr, g, bcs, infinite_gauge):
    """nonoscillatory (flux-corrected transport) limiting of the corrective
    pseudo-velocities (Smolarkiewicz & Grabowski 1990; libmpdata++ eqs. 37-42)"""
    dtype = psi.dtype
    ndim = psi.ndim
    psi_p = _pad_all(psi, bcs)
    psi0_p = _pad_all(psi0, bcs)
    axes = range(ndim)
    psi_max = _local_extrema(psi_p, psi0_p, axes, jnp.maximum)
    psi_min = _local_extrema(psi_p, psi0_p, axes, jnp.minimum)

    g_cell = g if g is not None else jnp.ones_like(psi)
    flux_in = jnp.zeros_like(psi)
    flux_out = jnp.zeros_like(psi)
    for d, gc_d in enumerate(gc_corr):
        if infinite_gauge:
            donor_l = donor_r = jnp.ones_like(gc_d)
        else:
            donor_l = jnp.abs(_face_view(psi_p, d, 0))
            donor_r = jnp.abs(_face_view(psi_p, d, 1))
        lf = tuple(
            slice(0, -1) if ax == d else slice(None) for ax in range(ndim)
        )
        rf = tuple(
            slice(1, None) if ax == d else slice(None) for ax in range(ndim)
        )
        # into cell i: + through left face, - through right face
        flux_in = (
            flux_in
            + jnp.maximum(gc_d, 0.0)[lf] * donor_l[lf]
            - jnp.minimum(gc_d, 0.0)[rf] * donor_r[rf]
        )
        # out of cell i: + through right face, - through left face
        flux_out = (
            flux_out
            + jnp.maximum(gc_d, 0.0)[rf] * donor_l[rf]
            - jnp.minimum(gc_d, 0.0)[lf] * donor_r[lf]
        )

    beta_up = _frac((psi_max - psi) * g_cell, flux_in, dtype)
    beta_dn = _frac((psi - psi_min) * g_cell, flux_out, dtype)

    limited = []
    for d, gc_d in enumerate(gc_corr):
        bu_p = _pad1(beta_up, d, bcs[d])
        bd_p = _pad1(beta_dn, d, bcs[d])
        idx_l = tuple(
            slice(0, -1) if ax == d else slice(None) for ax in range(ndim)
        )
        idx_r = tuple(
            slice(1, None) if ax == d else slice(None) for ax in range(ndim)
        )
        bd_donor = bd_p[idx_l]  # donor cell for GC' > 0 is the left cell
        bu_recv = bu_p[idx_r]
        bd_donor_neg = bd_p[idx_r]
        bu_recv_neg = bu_p[idx_l]
        pos = jnp.minimum(1.0, jnp.minimum(bd_donor, bu_recv))
        neg = jnp.minimum(1.0, jnp.minimum(bd_donor_neg, bu_recv_neg))
        limited.append(
            jnp.maximum(gc_d, 0.0) * pos + jnp.minimum(gc_d, 0.0) * neg
        )
    return limited


def mpdata_step(
    psi,
    gc,
    g=None,
    *,
    n_iters=2,
    infinite_gauge=False,
    nonoscillatory=False,
    third_order_terms=False,
    bcs=None,
):
    """advance one MPDATA time step; returns the updated cell field.
    ``gc``: tuple of face advector components (G * courant);
    ``bcs``: per-axis 'periodic' (default) or 'extrapolated'."""
    ndim = psi.ndim
    bcs = tuple(bcs) if bcs is not None else (PERIODIC,) * ndim
    assert len(gc) == ndim and len(bcs) == ndim
    g_cell = g if g is not None else None
    psi0 = psi

    psi_p = _pad_all(psi, bcs)
    fluxes = _upwind_fluxes(psi_p, gc, bcs)
    div = _flux_divergence(fluxes, psi.shape)
    psi = psi - (div / g_cell if g_cell is not None else div)

    for _ in range(n_iters - 1):
        gc_corr = _antidiffusive_gc(
            psi, gc, g_cell, bcs, infinite_gauge,
            third_order_terms=third_order_terms,
        )
        if nonoscillatory:
            gc_corr = _fct_limit(psi, psi0, gc_corr, g_cell, bcs, infinite_gauge)
        if infinite_gauge:
            fluxes = gc_corr  # donor-cell flux of the constant gauge field
        else:
            psi_p = _pad_all(psi, bcs)
            fluxes = _upwind_fluxes(psi_p, gc_corr, bcs)
        div = _flux_divergence(fluxes, psi.shape)
        psi = psi - (div / g_cell if g_cell is not None else div)
        gc = gc_corr
    return psi
