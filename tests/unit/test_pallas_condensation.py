"""The Pallas-Triton condensation kernel (``ops/pallas/condensation.py``)
against the XLA formulation of the same per-drop solve
(``ops/condensation.py`` ``make_drop_solver``), in interpret mode on the
CPU; its CUDA lowering; and the choice between the two (the CPU analogue
of the reference's FakeThrustRTC GPU-code testing)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysdm_tpu import Builder, Formulae
from pysdm_tpu.backends import CPU
from pysdm_tpu.dynamics import AmbientThermodynamics, Condensation
from pysdm_tpu.environments import Parcel
from pysdm_tpu.initialisation.sampling.spectral_sampling import (
    ConstantMultiplicity,
)
from pysdm_tpu.initialisation.spectra import Lognormal
from pysdm_tpu.ops import condensation as cond_ops
from pysdm_tpu.ops.pallas import condensation as kernel_ops
from pysdm_tpu.ops.pallas.condensation import BLOCK, masses_new_kernel


def _drop_solver(f, rtol_x=1e-6):
    return cond_ops.make_drop_solver(
        f, rtol_x=rtol_x, RH_rtol=1e-7, max_iters=16, bisect_iters=64
    )


def _drop_inputs(n, seed=11, dtype=jnp.float32):
    """a supersaturated cell's drops: wet radii 0.1-20 um on dry radii
    30-100 nm, every tenth drop inactive"""
    rng = np.random.default_rng(seed)
    r_wet = np.exp(rng.uniform(np.log(1e-7), np.log(20e-6), n))
    r_dry = np.exp(rng.uniform(np.log(3e-8), np.log(1e-7), n))
    full = functools.partial(np.full, n)
    return tuple(
        jnp.asarray(x, dtype)
        for x in (
            4 / 3 * np.pi * r_wet**3 * 1e3, 4 / 3 * np.pi * r_dry**3,
            full(0.61), full(0.0), full(0.01),
            full(290.0), rng.uniform(0.007, 0.013, n), full(1.19),
            full(0.5), (np.arange(n) % 10 != 0).astype(float),
            full(1.2), full(1.8e-5),
        )
    )


@pytest.fixture
def kernel_everywhere(monkeypatch):
    """select the kernel on the CPU too, run in interpret mode"""
    monkeypatch.setattr(cond_ops, "use_condensation_kernel", lambda dtype: True)
    monkeypatch.setattr(
        kernel_ops, "masses_new_kernel",
        functools.partial(masses_new_kernel, interpret=True),
    )


def _run_parcel(n_steps=50, n_sd=40, adaptive=False):
    formulae = Formulae(seed=44)
    env = Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.0158, T0=300.0, w=2.0,
    )
    builder = Builder(n_sd=n_sd, backend=CPU(formulae), environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=adaptive))
    spectrum = Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = ConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    particulator = builder.build(attributes)
    particulator.run(n_steps)
    return particulator


@pytest.mark.parametrize("adaptive", (False, True))
def test_fused_path_matches_xla(monkeypatch, adaptive):
    ref = _run_parcel(adaptive=adaptive)
    wm_ref = np.asarray(ref.get_attribute("water mass"))
    qv_ref = float(ref.get_env("qv")[0])

    monkeypatch.setattr(cond_ops, "use_condensation_kernel", lambda dtype: True)
    monkeypatch.setattr(
        kernel_ops, "masses_new_kernel",
        functools.partial(masses_new_kernel, interpret=True),
    )
    fused = _run_parcel(adaptive=adaptive)
    wm_fused = np.asarray(fused.get_attribute("water mass"))
    qv_fused = float(fused.get_env("qv")[0])

    assert bool(np.asarray(fused.get_counter("condensation_success")).all())
    # the kernel is an f32 pipeline; the XLA CPU path runs f64 —
    # trajectories agree to f32-level tolerances over 50 coupled steps
    np.testing.assert_allclose(wm_fused, wm_ref, rtol=2e-3)
    np.testing.assert_allclose(qv_fused, qv_ref, rtol=1e-4)


def test_fused_activation_sanity(kernel_everywhere):
    p = _run_parcel(n_steps=400, adaptive=True)
    assert bool(np.asarray(p.get_counter("condensation_success")).all())
    RH_max = float(np.asarray(p.get_counter("condensation_RH_max"))[0])
    assert 1.0 < RH_max < 1.05
    # activated droplets grew well beyond their dry size
    r = np.asarray(p.get_attribute("radius"))
    assert (r > 1e-6).sum() >= p.n_sd // 2


@pytest.mark.parametrize("n", (1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 7))
def test_kernel_matches_xla_formulation(n):
    """padding to whole blocks must not change any drop's answer: edge
    padding keeps the padded drops finite, and each block's early exit
    stops only once its own drops are within rtol_x"""
    f = Formulae(seed=44)
    masses_new = _drop_solver(f)
    args = _drop_inputs(n)
    mass_x, ok_x = jax.jit(masses_new)(*args)
    mass_k, ok_k = masses_new_kernel(masses_new, *args, interpret=True)
    assert mass_k.shape == (n,) and mass_k.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(ok_k), np.asarray(ok_x))
    x = lambda m: np.asarray(f.diffusion_coordinate.x(m), np.float64)  # noqa: E731
    np.testing.assert_allclose(
        x(mass_k), x(mass_x), rtol=0, atol=4e-6 * np.max(np.abs(x(args[0])))
    )
    # inactive drops keep their mass exactly
    inactive = np.asarray(args[9]) == 0
    np.testing.assert_array_equal(
        np.asarray(mass_k)[inactive], np.asarray(args[0])[inactive]
    )


def test_kernel_casts_f64_inputs_at_the_boundary():
    f = Formulae(seed=44)
    masses_new = _drop_solver(f)
    args64 = _drop_inputs(2 * BLOCK + 3, dtype=jnp.float64)
    args32 = tuple(a.astype(jnp.float32) for a in args64)
    mass64, ok64 = masses_new_kernel(masses_new, *args64, interpret=True)
    mass32, ok32 = masses_new_kernel(masses_new, *args32, interpret=True)
    assert mass64.dtype == jnp.float64 and ok64.dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(ok64), np.asarray(ok32))
    np.testing.assert_array_equal(
        np.asarray(mass64), np.asarray(mass32).astype(np.float64)
    )


def test_kernel_cross_lowers_for_cuda():
    """AOT-lower the kernel inside the full condensation solver for CUDA on
    the CPU host — catches Triton lowering regressions (e.g. a 64-bit value
    or a reduction the route refuses) without a card"""
    f = Formulae(seed=44)
    masses_new = _drop_solver(f)
    args = _drop_inputs(4096)
    lowered = jax.jit(
        lambda *a: masses_new_kernel(masses_new, *a)
    ).trace(*args).lower(lowering_platforms=("cuda",))
    assert "condensation_masses_new" in lowered.as_text()


@pytest.mark.parametrize("block", (128, 256, 512))
def test_kernel_cross_lowers_at_block_size(block):
    f = Formulae(seed=44)
    masses_new = _drop_solver(f)
    args = _drop_inputs(3 * block + 5)
    jax.jit(
        lambda *a: masses_new_kernel(masses_new, *a, block=block)
    ).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize(
    "backend, dtype, expected",
    (
        ("gpu", jnp.float32, True),
        ("gpu", jnp.float64, False),
        ("cpu", jnp.float32, False),
    ),
)
def test_kernel_choice(monkeypatch, backend, dtype, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert cond_ops.use_condensation_kernel(dtype) is expected


@pytest.mark.parametrize("path", ("xla", "kernel"))
def test_f32_equilibrium_haze_succeeds_at_x_old(monkeypatch, path):
    """regression for the f32 failure cascade: haze sitting at its f32
    Koehler equilibrium must SUCCEED with (near-)unchanged mass, on both the
    XLA path and the kernel. Before the fa-direction bracket fix,
    minfun(x_old) == 0 (or a residual whose sign disagrees with dx_old
    through the mass(x(m)) exp/log round-trip) made these drops report
    'unbracketable' and fail their cell every step (ops/condensation.py
    bracket expansion; reference semantics
    ``condensation_methods.py:498-530`` assume f64)."""
    if path == "kernel":
        monkeypatch.setattr(
            cond_ops, "use_condensation_kernel", lambda dtype: True
        )
        monkeypatch.setattr(
            kernel_ops, "masses_new_kernel",
            functools.partial(masses_new_kernel, interpret=True),
        )
    f = Formulae(seed=44)
    n = 64
    n_cell = 1
    # subsaturated cell (RH ~0.65 at thd=290, qv=7.5e-3, rhod=1.194)
    thd = jnp.full(n_cell, 290.0, jnp.float32)
    qv = jnp.full(n_cell, 7.5e-3, jnp.float32)
    rhod = jnp.full(n_cell, 1.1944, jnp.float32)
    m_d = rhod * 1.0
    rng = np.random.default_rng(5)
    r_dry = np.exp(rng.uniform(np.log(2e-8), np.log(2e-7), n))
    vdry = (4 / 3 * np.pi * r_dry**3).astype(np.float32)
    kappa = np.full(n, 0.61, np.float32)

    # drive each drop to its f32 equilibrium first: run the solver many
    # times until masses stop changing, then assert the *settled* state
    # keeps succeeding (pre-fix: settled haze flips to persistent failure)
    solver = cond_ops.make_condensation_solver(
        f, n_cell=n_cell, dt=0.1, adaptive=False
    )
    wm = jnp.asarray(4 / 3 * np.pi * (2 * r_dry) ** 3 * 1e3, jnp.float32)
    attrs = dict(
        vdry=jnp.asarray(vdry), kappa=jnp.asarray(kappa),
        f_org=jnp.zeros(n, jnp.float32),
        reynolds_number=jnp.full(n, 0.01, jnp.float32),
        v_cr=jnp.asarray(4 / 3 * np.pi * (2e-5) ** 3 * np.ones(n), jnp.float32),
    )
    kwargs = dict(
        multiplicity=jnp.ones(n, jnp.float32),
        cell_of_drop=jnp.zeros(n, jnp.int32),
        cell_start=jnp.asarray([0, n], jnp.int32),
        n_substeps=jnp.ones(n_cell, jnp.int32),
        thd=thd, qv=qv, rhod=rhod, pthd=thd, pqv=qv, prhod=rhod,
        m_d=m_d, air_density=rhod * 1.0075,
        air_viscosity=jnp.full(n_cell, 1.8e-5, jnp.float32),
    )
    settled = False
    for _ in range(60):
        out = solver(attrs={**attrs, "water_mass": wm}, **kwargs)
        wm_new = out[0]
        # f32 equilibrium is a fixed point up to a bisection-granularity
        # limit cycle (~rtol_x * |x| in the log coordinate -> ~4e-5 mass)
        settled = bool(
            jnp.max(jnp.abs(wm_new - wm) / wm) < 5e-5
        )
        wm = wm_new
        if settled:
            break
    assert settled, "haze did not reach its f32 equilibrium in 60 steps"

    # at the settled f32 equilibrium: every solve must still SUCCEED and
    # keep the mass (pre-fix: success=False for the fa==0 / sign-flip drops)
    out = solver(attrs={**attrs, "water_mass": wm}, **kwargs)
    assert bool(np.asarray(out[5]).all()), "settled haze must not fail"
    np.testing.assert_allclose(
        np.asarray(out[0]), np.asarray(wm), rtol=1e-4
    )


def test_early_exit_honors_rtol_x():
    """the kernel's early-exit bisection must deliver roots within the
    requested rtol_x: kernels built with loose vs tight tolerance agree on
    the diffusion-coordinate root to the LOOSE tolerance, and the tight
    kernel refines further (i.e. rtol_x actually steers the stop)"""
    f = Formulae(seed=44)
    n = 4096
    rng = np.random.default_rng(11)
    r_wet = np.exp(rng.uniform(np.log(1e-6), np.log(20e-6), n))
    wm = jnp.asarray((4 / 3 * np.pi * r_wet**3 * 1e3), jnp.float32)
    r_dry = np.exp(rng.uniform(np.log(3e-8), np.log(1e-7), n))
    vdry = jnp.asarray((4 / 3 * np.pi * r_dry**3), jnp.float32)
    kappa = jnp.full((n,), 0.61, jnp.float32)
    f_org = jnp.zeros((n,), jnp.float32)
    reyn = jnp.full((n,), 0.01, jnp.float32)
    # supersaturated cell: droplets grow, roots differ from x_old
    thd_d = jnp.full((n,), 290.0, jnp.float32)
    qv_d = jnp.full((n,), 0.013, jnp.float32)
    rhod_d = jnp.full((n,), 1.1944, jnp.float32)
    dt_sub = jnp.full((n,), 0.5, jnp.float32)
    act = jnp.ones((n,), jnp.float32)
    rho_air = jnp.full((n,), 1.2, jnp.float32)
    mu_air = jnp.full((n,), 1.8e-5, jnp.float32)
    args = (wm, vdry, kappa, f_org, reyn, thd_d, qv_d, rhod_d,
            dt_sub, act, rho_air, mu_air)

    roots = {}
    for rtol_x in (1e-2, 1e-7):
        mass_new, success = masses_new_kernel(
            _drop_solver(f, rtol_x=rtol_x), *args, interpret=True
        )
        assert bool(np.asarray(success).all())
        roots[rtol_x] = np.asarray(
            f.diffusion_coordinate.x(jnp.asarray(mass_new)), np.float64
        )
    x_loose, x_tight = roots[1e-2], roots[1e-7]
    # droplets actually moved
    x_old = np.asarray(f.diffusion_coordinate.x(wm), np.float64)
    assert np.max(np.abs(x_tight - x_old)) > 0
    # loose root within its own tolerance of the refined root
    np.testing.assert_allclose(x_loose, x_tight, rtol=2e-2)
    # and the tolerances differ in effect (early exit actually triggers)
    assert np.max(np.abs(x_loose - x_tight)) > 0
