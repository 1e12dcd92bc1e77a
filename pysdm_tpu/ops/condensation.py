"""Vectorized implicit-in-particle-size condensation solver.

Semantics parity with the reference CPU solver
(``PySDM/backends/impl_numba/methods/condensation_methods.py``): trapezoidal
per-cell coupling of (thd, qv, rhod) with per-droplet implicit mass solves
(``step_impl`` 256-356, ``calculate_ml_new`` 408-572) and Richardson-style
per-cell substep adaptation (``adapt_substeps`` 178-228).

Design (SURVEY.md §7 delta #5):
- the per-droplet root find is a bracketed bisection with a masked early
  exit (the reference GPU backend's choice, ``bisection.py``, rather than
  the CPU's branchy TOMS748). ``make_drop_solver`` writes it once, for
  arrays of drops: XLA runs it over the whole particle axis, and on a GPU
  in float32 the Pallas-Triton kernel (``ops/pallas/condensation.py``)
  runs the same function over blocks of drops held in registers;
- particles must arrive sorted by cell id (the Condensation dynamic sorts):
  per-cell reductions (liquid mass ml, success flags) are deterministic
  cumsum differences over the cell segments, with no scatter;
- cell->drop broadcasting is one row gather of the packed cell state per
  substep, and the thermodynamic fields (T, p, RH, ...) are recomputed
  elementwise at drop granularity;
- cells with different substep counts advance in lockstep under one masked
  ``while_loop`` — spent cells are frozen, shapes stay static.
"""

import jax
import jax.numpy as jnp

from .segments import sorted_segment_sum


def _percell_sum(values, cell_start, n_cell):
    """per-cell sum over cell-sorted slots; the single-cell (0D parcel/box)
    case short-circuits the cumsum-difference machinery to one plain sum
    (cheaper and exact-associative)"""
    if n_cell == 1:
        return jnp.sum(values)[None]
    return sorted_segment_sum(values, cell_start, n_cell)


def _cell_rows_to_drops(values_cell, cell_of_drop, n_cell):
    """broadcast per-cell rows (n_cell, ...) to drops; dead drops may carry
    any cell id, so the index is clamped into the table"""
    return values_cell[jnp.clip(cell_of_drop, 0, n_cell - 1)]


def compute_thermo(f, thd, qv, rhod, air_density, air_viscosity):
    """(T, p, RH, lv, pvs, DTp, KTp, Sc) from the state-variable triplet,
    elementwise (cells or drops)"""
    T = f.state_variable_triplet.T(rhod, thd)
    p = f.state_variable_triplet.p(rhod, T, qv)
    pv = f.state_variable_triplet.pv(p, qv)
    lv = f.latent_heat_vapourisation.lv(T)
    pvs = f.saturation_vapour_pressure.pvs_water(T)
    # Neglect-variant thermics return Python constants: pin them to the
    # state's dtype (under x64 a bare constant would widen f32 math to f64)
    DTp = jnp.broadcast_to(
        jnp.asarray(f.diffusion_thermics.D(T, p), T.dtype), T.shape
    )
    KTp = jnp.broadcast_to(
        jnp.asarray(f.diffusion_thermics.K(T, p), T.dtype), T.shape
    )
    RH = pv / pvs
    Sc = f.trivia.air_schmidt_number(
        dynamic_viscosity=air_viscosity, diffusivity=DTp, density=air_density
    )
    return T, p, RH, lv, pvs, DTp, KTp, Sc


# per-drop inputs of the solve, in argument order
DROP_INPUTS = (
    "water_mass", "vdry", "kappa", "f_org", "reynolds_number",
    "thd", "qv", "rhod", "dt_sub", "active", "air_density", "air_viscosity",
)


def make_drop_solver(formulae, *, rtol_x, RH_rtol, max_iters, bisect_iters):
    """the per-droplet implicit mass solve (reference ``calculate_ml_new``
    408-572), elementwise over drops. Returns
    ``masses_new(*inputs) -> (mass_new, success)`` taking the arrays named
    in ``DROP_INPUTS`` (``active`` > 0 marks drops of cells being stepped).

    Written so that it also serves as the body of the Triton kernel:
    elementwise jnp only, int32 loop counters, and the bisection's early
    exit tests a max-reduction over the drops it holds (``jnp.any`` lowers
    to a reduction the Triton route refuses). XLA evaluates it over the
    whole particle axis, the kernel over one block of drops."""
    f = formulae
    const = f.constants
    x_max = f.diffusion_coordinate.x_max()

    def minfun(x_new, x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd):
        mass_new = f.diffusion_coordinate.mass(x_new)
        volume_new = f.particle_shape_and_density.mass_to_volume(mass_new)
        r_new = f.trivia.radius(volume_new)
        sgm = f.surface_tension.sigma(T, volume_new, const.PI_4_3 * rd3, f_org)
        RH_eq = f.hygroscopicity.RH_eq(r_new, T, kappa, rd3, sgm)
        r_dr_dt = f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd)
        dm_dt = f.particle_shape_and_density.dm_dt(r=r_new, r_dr_dt=r_dr_dt)
        res = x_old - x_new + dt_sub * f.diffusion_coordinate.dx_dt(mass_new, dm_dt)
        return jnp.where(x_new > x_max, x_old - x_new, res)

    def masses_new(
        water_mass, vdry, kappa, f_org, reynolds_number,
        thd, qv, rhod, dt_sub, active_drop, air_density, air_viscosity,
    ):
        ftype = water_mass.dtype
        T, p, RH, lv, pvs, DTp, KTp, Sc = compute_thermo(
            f, thd, qv, rhod, air_density, air_viscosity
        )
        active = (water_mass > 0) & (active_drop > 0)

        safe_mass = jnp.where(active, water_mass, jnp.asarray(1e-18, ftype))
        v_drop = f.particle_shape_and_density.mass_to_volume(safe_mass)
        x_old = f.diffusion_coordinate.x(safe_mass)
        r_old = f.trivia.radius(v_drop)
        x_insane = f.diffusion_coordinate.x(
            f.particle_shape_and_density.volume_to_mass(vdry / 100)
        )
        rd3 = vdry / const.PI_4_3
        sgm = f.surface_tension.sigma(T, v_drop, vdry, f_org)
        RH_eq = f.hygroscopicity.RH_eq(r_old, T, kappa, rd3, sgm)

        lambdaK = f.diffusion_kinetics.lambdaK(T, p)
        lambdaD = f.diffusion_kinetics.lambdaD(DTp, T)
        Dr = f.diffusion_kinetics.D(DTp, r_old, lambdaD)
        Kr = f.diffusion_kinetics.K(KTp, r_old, lambdaK)
        vent = f.ventilation.ventilation_coefficient(
            sqrt_re_times_cbrt_sc=f.trivia.sqrt_re_times_cbrt_sc(
                Re=reynolds_number, Sc=Sc
            )
        )
        Fk = f.drop_growth.Fk(T=T, K=Kr * vent, lv=lv)
        Fd = f.drop_growth.Fd(T=T, D=Dr * vent, pvs=pvs)

        at_equilibrium = f.trivia.within_tolerance(
            jnp.abs(RH - RH_eq), RH, RH_rtol
        )
        r_dr_dt_old = f.drop_growth.r_dr_dt(RH_eq=RH_eq, RH=RH, Fk=Fk, Fd=Fd)
        dm_dt_old = f.particle_shape_and_density.dm_dt(r=r_old, r_dr_dt=r_dr_dt_old)
        dx_old = dt_sub * f.diffusion_coordinate.dx_dt(safe_mass, dm_dt_old)
        dx_old = jnp.where(at_equilibrium, jnp.zeros((), ftype), dx_old)
        need_solve = active & (dx_old != 0)

        margs = (x_old, dt_sub, kappa, f_org, rd3, T, RH, Fk, Fd)
        a = x_old
        fa = minfun(a, *margs)

        # f32-robust bracket expansion (generalizes reference 498-530).
        # Two haze-at-equilibrium pathologies bite a float32 pipeline
        # (the f64 reference cannot hit them at these scales):
        # (a) fa == 0 exactly — x_old already solves the implicit
        #     equation to machine precision; fa*fb < 0 can then never
        #     hold, so the drop would be mis-reported unbracketable;
        # (b) the minfun residual at a disagrees in SIGN with dx_old
        #     (mass(x(m)) round-trips through exp/log, shifting the
        #     equilibrium by an ulp) — expanding in dx_old's direction
        #     then walks away from the root forever.
        # minfun is asymptotically decreasing in x_new (the -x_new term
        # dominates; beyond x_max it is exactly x_old - x_new), so the
        # root lies on the side where f flips sign: probe UP when
        # fa > 0, DOWN when fa < 0, with the increment magnitude floored
        # at a few ulps of x_old (a sub-resolution dx would freeze the
        # expansion: b = a + dx*2^k rounds back to a).
        dx_mag = jnp.maximum(
            jnp.abs(dx_old), 8 * jnp.finfo(ftype).eps * jnp.abs(x_old)
        )
        dx_step = jnp.where(fa > 0, dx_mag, -dx_mag)
        converged_at_a = need_solve & (fa == 0)

        b = jnp.maximum(x_insane, a + dx_step)
        fb = minfun(b, *margs)

        # bracket expansion (reference 498-530): double dx until sign change
        def expand_body(_, carry):
            b, fb, scale = carry
            not_bracketed = (fa * fb >= 0) & need_solve
            b_try = jnp.maximum(x_insane, a + dx_step * scale)
            fb_try = minfun(b_try, *margs)
            b = jnp.where(not_bracketed, b_try, b)
            fb = jnp.where(not_bracketed, fb_try, fb)
            return b, fb, scale * 2

        b, fb, _ = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(max_iters), expand_body,
            (b, fb, jnp.asarray(2.0, ftype)),
        )
        bracketed = (fa * fb < 0) | converged_at_a
        success_drop = ~need_solve | bracketed

        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)
        flo = jnp.where(a <= b, fa, fb)

        # bisection with masked early exit (GPU-backend-style root find,
        # reference ``impl_thrust_rtc/bisection.py``)
        solving = need_solve & bracketed & ~converged_at_a
        x_scale = jnp.abs(jnp.where(x_old != 0, x_old, jnp.ones((), ftype)))

        def bisect_cond(carry):
            i, lo, hi, _ = carry
            unconverged = solving & ~f.trivia.within_tolerance(
                hi - lo, x_scale, rtol_x
            )
            return (i < bisect_iters) & (
                jnp.max(unconverged.astype(jnp.int32)) > 0
            )

        def bisect_body(carry):
            i, lo, hi, flo = carry
            mid = 0.5 * (lo + hi)
            fmid = minfun(mid, *margs)
            go_lo = flo * fmid < 0
            hi = jnp.where(go_lo, mid, hi)
            lo_new = jnp.where(go_lo, lo, mid)
            flo = jnp.where(go_lo, flo, fmid)
            return i + 1, lo_new, hi, flo

        _, lo, hi, _ = jax.lax.while_loop(
            bisect_cond, bisect_body, (jnp.int32(0), lo, hi, flo)
        )
        x_new = jnp.where(solving, 0.5 * (lo + hi), x_old)
        mass_new = f.diffusion_coordinate.mass(x_new)
        mass_new = jnp.where(active, mass_new, water_mass)
        # failure detection (reference ``condensation_methods.py:670-696``
        # raises on solver failure; here it is a counted per-cell failure):
        # a non-finite root — the solve sits on a numerical cliff, e.g. a
        # sub-attogram haze drop whose log-coordinate bracket explodes —
        # must not poison the state; keep the old mass and flag the drop
        finite = jnp.isfinite(mass_new)
        mass_new = jnp.where(finite, mass_new, water_mass)
        return mass_new, (success_drop & finite) | ~active

    return masses_new


def use_condensation_kernel(dtype):
    """the Triton kernel runs where it was built for: a GPU, in float32;
    everything else takes the XLA formulation"""
    return jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float32


def make_condensation_solver(
    formulae,
    *,
    n_cell,
    dt,
    rtol_x=1e-6,
    rtol_thd=1e-6,
    dt_range=(1e-4, 1.0),
    adaptive=True,
    fuse=32,
    multiplier=2,
    RH_rtol=1e-7,
    max_iters=16,
    bisect_iters=64,
    failure_doubling_cap=64,
):
    """build the jit-traceable condensation step closed over formulae/config"""
    f = formulae
    masses_new = make_drop_solver(
        f, rtol_x=rtol_x, RH_rtol=RH_rtol, max_iters=max_iters,
        bisect_iters=bisect_iters,
    )
    if dt_range[1] > dt:
        dt_range = (dt_range[0], dt)
    n_substeps_max = int(dt // dt_range[0])
    n_substeps_min = max(1, int(-(-dt // dt_range[1])))  # ceil

    def substep(
        *, attrs, mult_f, cell_of_drop, cell_start, cell_active, dt_sub_cell,
        thd, qv, rhod, ml_old,
        dthd_dt_pred, dqv_dt_pred, drhod_dt, m_d,
        air_density, air_viscosity, fake,
    ):
        """one trapezoidal substep (reference ``step_impl`` 256-356) on the
        cells where cell_active; ``cell_of_drop`` must be sorted ascending
        (dead drops trailing) with segment starts ``cell_start``"""
        ftype = thd.dtype
        act = cell_active
        dt_sub = dt_sub_cell
        thd0, qv0, rhod0 = thd, qv, rhod  # rollback state on failure
        thd = jnp.where(act, thd + dt_sub * dthd_dt_pred / 2, thd)
        qv = jnp.where(act, qv + dt_sub * dqv_dt_pred / 2, qv)
        rhod = jnp.where(act, rhod + dt_sub * drhod_dt / 2, rhod)

        T, _, RH, lv, _, _, _, _ = compute_thermo(
            f, thd, qv, rhod, air_density, air_viscosity
        )
        # one row gather of the packed cell state per substep
        pack = jnp.stack(
            [thd, qv, rhod, dt_sub_cell, act.astype(ftype),
             air_density, air_viscosity],
            axis=1,
        )
        pack_d = _cell_rows_to_drops(pack, cell_of_drop, n_cell)
        thd_d, qv_d, rhod_d, dt_sub_d, act_d, rho_d, mu_d = (
            pack_d[:, i] for i in range(7)
        )
        # dead drops (multiplicity 0) are inert: when the state rides a
        # shared sort (bucket-shuffle order) they sit INSIDE the last
        # cell's segment rather than a trailing bucket, and must neither
        # be solved nor allowed to fail the cell
        act_d = jnp.where(mult_f > 0, act_d, jnp.zeros((), ftype))
        drop_args = (
            attrs["water_mass"], attrs["vdry"], attrs["kappa"],
            attrs["f_org"], attrs["reynolds_number"],
            thd_d, qv_d, rhod_d, dt_sub_d, act_d, rho_d, mu_d,
        )
        if use_condensation_kernel(ftype):
            from .pallas.condensation import masses_new_kernel

            mass_new, success_drop = masses_new_kernel(masses_new, *drop_args)
        else:
            mass_new, success_drop = masses_new(*drop_args)
        ml_new = _percell_sum(
            jnp.where(mass_new > 0, mult_f * mass_new, 0.0), cell_start, n_cell
        )
        dml_dt = (ml_new - ml_old) / jnp.where(dt_sub > 0, dt_sub, 1.0)
        dqv_dt_corr = -dml_dt / m_d
        dthd_dt_corr = f.state_variable_triplet.dthd_dt(
            rhod=rhod, thd=thd, T=T,
            d_water_vapour_mixing_ratio__dt=dqv_dt_corr, lv=lv,
        )
        thd = jnp.where(act, thd + dt_sub * (dthd_dt_pred / 2 + dthd_dt_corr), thd)
        qv = jnp.where(act, qv + dt_sub * (dqv_dt_pred / 2 + dqv_dt_corr), qv)
        rhod = jnp.where(act, rhod + dt_sub * drhod_dt / 2, rhod)

        fails = _percell_sum(
            (~success_drop).astype(jnp.float32), cell_start, n_cell
        )
        # failure detection at the cell-coupling level (the reference raises
        # "Condensation failed", ``dynamics/condensation.py:110-111``; here
        # the cell is rolled back to its substep-entry state and counted):
        # a non-finite thd/qv — the trapezoidal correction sitting on a
        # numerical cliff — must not poison subsequent substeps
        finite_cell = (
            jnp.isfinite(thd) & jnp.isfinite(qv) & jnp.isfinite(rhod)
        )
        thd = jnp.where(finite_cell, thd, thd0)
        qv = jnp.where(finite_cell, qv, qv0)
        rhod = jnp.where(finite_cell, rhod, rhod0)
        success_cell = ((fails == 0) & finite_cell) | ~act

        # a rolled-back cell must be rolled back IN FULL: its drops keep
        # their substep-entry masses, else liquid water changes while the
        # vapour/heat fields are restored and the cell's water and energy
        # budgets silently diverge (the reference aborts instead)
        ok_d = _cell_rows_to_drops(finite_cell, cell_of_drop, n_cell)
        zeros_cell = jnp.zeros(n_cell, ftype)
        if fake:
            attrs_out = attrs
            n_act = n_deact = n_ripen = zeros_cell
        else:
            attrs_out = {**attrs, "water_mass": jnp.where(
                (act_d > 0) & ok_d, mass_new, attrs["water_mass"]
            )}
            # activation-event counting (reference ``calculate_ml_new``,
            # condensation_methods.py:149-161): multiplicity-weighted counts
            # of drops crossing the critical mass during this substep
            mass_old = attrs["water_mass"]
            mass_cr = f.particle_shape_and_density.volume_to_mass(attrs["v_cr"])
            committed = (act_d > 0) & ok_d
            weight = jnp.where(committed, mult_f, 0.0)
            n_act = _percell_sum(
                jnp.where((mass_new > mass_cr) & (mass_cr > mass_old), weight, 0.0),
                cell_start, n_cell,
            )
            n_deact = _percell_sum(
                jnp.where((mass_new < mass_cr) & (mass_cr < mass_old), weight, 0.0),
                cell_start, n_cell,
            )
            n_act_growing = _percell_sum(
                jnp.where((mass_new > mass_cr) & (mass_new > mass_old), weight, 0.0),
                cell_start, n_cell,
            )
            n_ripen = jnp.where(n_deact > 0, n_act_growing, zeros_cell)
        ml_out = jnp.where(act & finite_cell, ml_new, ml_old)
        return (attrs_out, thd, qv, rhod, ml_out, RH, success_cell,
                (n_act, n_deact, n_ripen))

    def run_substeps(
        *, attrs, mult_f, cell_of_drop, cell_start, n_substeps,
        thd, qv, rhod, dthd_dt_pred, dqv_dt_pred, drhod_dt, m_d,
        air_density, air_viscosity,
    ):
        """advance every cell through its own n_substeps (lockstep, masked)"""
        dt_sub_cell = dt / n_substeps.astype(thd.dtype)
        ml0 = _percell_sum(
            jnp.where(attrs["water_mass"] > 0, mult_f * attrs["water_mass"], 0.0),
            cell_start,
            n_cell,
        )
        ftype = thd.dtype
        zeros_cell = jnp.zeros(n_cell, ftype)
        init = (
            0, attrs["water_mass"], thd, qv, rhod, ml0,
            jnp.zeros(n_cell, ftype),  # RH_max
            jnp.ones(n_cell, dtype=bool),  # success
            (zeros_cell, zeros_cell, zeros_cell),  # event counts
        )

        def cond(carry):
            s = carry[0]
            return s < jnp.max(n_substeps)

        def body(carry):
            s, water_mass, thd, qv, rhod, ml_old, RH_max, success, events = carry
            cell_active = s < n_substeps
            attrs_s = {**attrs, "water_mass": water_mass}
            attrs_s, thd, qv, rhod, ml_old, RH, success_cell, ev = substep(
                attrs=attrs_s, mult_f=mult_f, cell_of_drop=cell_of_drop,
                cell_start=cell_start,
                cell_active=cell_active, dt_sub_cell=dt_sub_cell,
                thd=thd, qv=qv, rhod=rhod, ml_old=ml_old,
                dthd_dt_pred=dthd_dt_pred, dqv_dt_pred=dqv_dt_pred,
                drhod_dt=drhod_dt, m_d=m_d,
                air_density=air_density, air_viscosity=air_viscosity,
                fake=False,
            )
            RH_max = jnp.where(cell_active, jnp.maximum(RH_max, RH), RH_max)
            success = success & success_cell
            events = tuple(
                jnp.where(cell_active, acc + e, acc)
                for acc, e in zip(events, ev)
            )
            return (s + 1, attrs_s["water_mass"], thd, qv, rhod, ml_old,
                    RH_max, success, events)

        (_, water_mass, thd, qv, rhod, _, RH_max, success, events) = (
            jax.lax.while_loop(cond, body, init)
        )
        return water_mass, thd, qv, rhod, RH_max, success, events

    def step_fake(
        *, attrs, mult_f, cell_of_drop, cell_start, n_substeps,
        thd, qv, rhod, dthd_dt_pred, dqv_dt_pred, drhod_dt, m_d,
        air_density, air_viscosity, cell_mask,
    ):
        """ONE substep of length dt/n_substeps without committing attributes
        (reference ``make_step_fake``); returns (thd_new, success)"""
        dt_sub_cell = dt / n_substeps.astype(thd.dtype)
        ml0 = _percell_sum(
            jnp.where(attrs["water_mass"] > 0, mult_f * attrs["water_mass"], 0.0),
            cell_start,
            n_cell,
        )
        _, thd_new, _, _, _, _, success, _ = substep(
            attrs=attrs, mult_f=mult_f, cell_of_drop=cell_of_drop,
            cell_start=cell_start,
            cell_active=cell_mask, dt_sub_cell=dt_sub_cell,
            thd=thd, qv=qv, rhod=rhod, ml_old=ml0,
            dthd_dt_pred=dthd_dt_pred, dqv_dt_pred=dqv_dt_pred,
            drhod_dt=drhod_dt, m_d=m_d,
            air_density=air_density, air_viscosity=air_viscosity,
            fake=True,
        )
        return thd_new, success

    def adapt_substeps(*, n_substeps_prev, thd, fake_kwargs):
        """per-cell Richardson adaptation (reference ``adapt_substeps``
        178-228): double n until the one-substep thd error estimate
        |dthd(dt/n) - multiplier*dthd(dt/(mult*n))| is within rtol_thd.

        n is carried as FLOAT through the doubling loops: powers of two
        are exact in f32/f64 and cannot overflow — an int32 n doubled by
        a persistently-failing cell wraps to 0 after 32 doublings
        (5 * 2^32 == 0), making dt_sub = dt/0 = inf and silently freezing
        the cell. thd_long is carried through the phase-1 while_loop,
        saving one fake substep per adaptive step."""
        ftype = thd.dtype
        n_max_f = jnp.asarray(n_substeps_max, ftype)
        # a cell whose fake substep STILL fails at this count will not be
        # saved by more halving — freeze its n here and let the real
        # substeps report the per-cell failure (counted, loud). Without
        # the cap, failure-doubling marches n to n_substeps_max (dt/1e-4
        # = 50000 at dt=5s): a 50000-iteration lockstep substep loop over
        # every drop runs for minutes (the reference raises on failure
        # instead of re-halving forever, impl_numba
        # condensation_methods.py:670-696)
        n_fail_cap = jnp.asarray(
            max(n_substeps_min, min(n_substeps_max, failure_doubling_cap)),
            ftype,
        )
        n = jnp.maximum(
            jnp.asarray(n_substeps_min, ftype),
            (n_substeps_prev // multiplier).astype(ftype),
        )
        all_cells = jnp.ones(n_cell, dtype=bool)

        # phase 1: double until the fake substep succeeds (or the cell
        # hits the failure cap); thd_long is carried out of the loop (the
        # attempt that succeeds for a cell IS its dt/n trial) — saving a
        # full extra fake substep per step
        def p1_cond(carry):
            i, n, ok, _ = carry
            return (i < fuse) & jnp.any(~ok)

        def p1_body(carry):
            i, n, ok, thd_long = carry
            thd_new, success = step_fake(n_substeps=n, thd=thd,
                                         cell_mask=~ok, **fake_kwargs)
            thd_long = jnp.where(~ok & success, thd_new, thd_long)
            newly_ok = ok | success | (n >= n_fail_cap)
            n = jnp.where(
                newly_ok, n, jnp.minimum(n * multiplier, n_fail_cap)
            )
            return i + 1, n, newly_ok, thd_long

        thd_long0, ok0 = step_fake(n_substeps=n, thd=thd, cell_mask=all_cells,
                                   **fake_kwargs)
        _, n, _, thd_long = jax.lax.while_loop(
            p1_cond, p1_body,
            (0, jnp.where(ok0, n, jnp.minimum(n * multiplier, n_fail_cap)),
             ok0, thd_long0),
        )
        n = jnp.minimum(n, n_max_f)

        # the Richardson error estimate is a difference of two same-scale
        # trajectories: it cannot meaningfully drop below a few ulps of
        # thd. In float32 a tolerance below that floor would keep
        # 'within' false forever and double n to n_substeps_max — another
        # route to the minutes-long lockstep loop. (f64: the floor is
        # ~1e-15, never binding.)
        rtol_eff = max(rtol_thd, 16 * float(jnp.finfo(ftype).eps))

        # phase 2: Richardson comparison against mult*n
        def p2_cond(carry):
            i, n, done, _ = carry
            return (i < fuse) & jnp.any(~done)

        def p2_body(carry):
            i, n, done, thd_long = carry
            thd_short, success = step_fake(n_substeps=n * multiplier, thd=thd,
                                           cell_mask=~done, **fake_kwargs)
            dthd_long = thd_long - thd
            dthd_short = thd_short - thd
            error_estimate = jnp.abs(dthd_long - multiplier * dthd_short)
            within = f.trivia.within_tolerance(error_estimate, thd, rtol_eff)
            newly_done = done | within | (n * multiplier > n_max_f)
            n = jnp.where(done | within, n, n * multiplier)
            thd_long = jnp.where(done, thd_long, thd_short)
            return i + 1, n, newly_done, thd_long

        _, n, _, _ = jax.lax.while_loop(
            p2_cond, p2_body,
            (0, n, jnp.zeros(n_cell, dtype=bool), thd_long),
        )
        return jnp.minimum(n, n_max_f).astype(jnp.int32)

    def solve(
        *, attrs, multiplicity, cell_of_drop, cell_start, n_substeps,
        thd, qv, rhod, pthd, pqv, prhod, m_d, air_density, air_viscosity,
    ):
        """full condensation step (reference ``solve``, 639-698) over drops
        sorted by cell; returns
        (water_mass, pthd, pqv, n_substeps, RH_max, success)"""
        ftype = thd.dtype
        mult_f = multiplicity.astype(ftype)
        dthd_dt_pred = (pthd - thd) / dt
        dqv_dt_pred = (pqv - qv) / dt
        drhod_dt = (prhod - rhod) / dt
        fake_kwargs = dict(
            attrs=attrs, mult_f=mult_f, cell_of_drop=cell_of_drop,
            cell_start=cell_start,
            qv=qv, rhod=rhod,
            dthd_dt_pred=dthd_dt_pred, dqv_dt_pred=dqv_dt_pred,
            drhod_dt=drhod_dt, m_d=m_d,
            air_density=air_density, air_viscosity=air_viscosity,
        )
        if adaptive:
            n_substeps = adapt_substeps(
                n_substeps_prev=n_substeps, thd=thd, fake_kwargs=fake_kwargs
            )
        water_mass, thd_new, qv_new, _, RH_max, success, events = run_substeps(
            attrs=attrs, mult_f=mult_f, cell_of_drop=cell_of_drop,
            cell_start=cell_start,
            n_substeps=n_substeps,
            thd=thd, qv=qv, rhod=rhod,
            dthd_dt_pred=dthd_dt_pred, dqv_dt_pred=dqv_dt_pred,
            drhod_dt=drhod_dt, m_d=m_d,
            air_density=air_density, air_viscosity=air_viscosity,
        )
        return water_mass, thd_new, qv_new, n_substeps, RH_max, success, events

    return solve
