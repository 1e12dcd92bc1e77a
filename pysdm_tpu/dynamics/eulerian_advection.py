"""Eulerian advection dynamic + MPDATA solver couplings.

Parity: reference ``PySDM/dynamics/eulerian_advection.py`` plus the example
couplings (``examples/.../Shipway_and_Hill_2012/mpdata_1d.py``,
``examples/.../utils/kinematic_2d/mpdata_2d.py``) — the reference outsources
the solver to the external PyMPDATA package and pays a host<->device field
download per step; here the advection runs inside the jitted composed step on
the env-state fields, so the Lagrangian<->Eulerian coupling is a pure dataflow
edge that XLA can schedule (the equivalent of the reference's
async-thread overlap).

Per-step dataflow (mirrors the reference's buffer shuttling):
- sync (AmbientThermodynamics): ``pred_qv <- mpdata_qv``, ``pred_thd <- mpdata_thd``
- Condensation updates ``pred_qv``/``pred_thd``
- EulerianAdvection: ``mpdata_* <- mpdata_step(pred_*)``; also writes the
  particle courant fields (``courant_d = GC_d / rhod_at_faces``) consumed by
  Displacement (reference ``simulation.py`` courant upload)
- commit: ``qv <- pred_qv`` etc.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.mpdata import mpdata_step, EXTRAPOLATED, PERIODIC


class EulerianAdvection:
    """triggers the coupled solver inside the composed step (reference
    ``dynamics/eulerian_advection.py``)"""

    def __init__(self, solvers):
        self.solvers = solvers
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        if hasattr(self.solvers, "register"):
            self.solvers.register(builder)

    def make_step(self, particulator):
        return self.solvers.make_step(particulator)


def _eval_advector(fn, t, shape, dtype):
    """advector profiles written with jax ops trace directly; plain
    numpy/scipy callables fall back to a host callback"""
    try:
        return jnp.broadcast_to(jnp.asarray(fn(t), dtype=dtype), shape)
    except (
        jax.errors.TracerArrayConversionError,
        jax.errors.ConcretizationTypeError,
        TypeError,
    ):
        return jax.pure_callback(
            lambda tt: np.broadcast_to(
                np.asarray(fn(float(tt)), dtype=dtype), shape
            ),
            jax.ShapeDtypeStruct(shape, dtype),
            t,
        )


class MPDATA_2D:
    """2D prescribed-flow coupling (reference ``mpdata_2d.py``): advects thd
    and the water-vapour mixing ratio with a stream-function-derived,
    discretely-nondivergent advector; periodic BCs; g factor = rhod(z).
    Also publishes the particle courant fields (advector / rhod at faces)."""

    def __init__(
        self,
        *,
        advectees,
        stream_function,
        rhod_of_zZ,
        dt,
        grid,
        size,
        n_iters=2,
        infinite_gauge=True,
        nonoscillatory=True,
        third_order_terms=False,
    ):
        from ..impl import arakawa_c

        self.advectees = advectees
        self.grid = tuple(grid)
        self.dt = dt
        gc = arakawa_c.nondivergent_vector_field_2d(
            grid, size, dt, stream_function, t=0.0
        )
        self.gc = tuple(np.asarray(c, dtype=float) for c in gc)
        for d, c in enumerate(self.gc):
            np.testing.assert_array_less(np.abs(c), 1.0)
        self.g_factor = arakawa_c.make_rhod(grid, rhod_of_zZ)
        g_vec = (
            rhod_of_zZ(arakawa_c.x_vec_coord(grid)[-1]),
            rhod_of_zZ(arakawa_c.z_vec_coord(grid)[-1]),
        )
        # particle courant = GC / rhod at the faces (reference
        # ``mpdata_2d.py:refresh_advector``)
        self.courant = tuple(self.gc[d] / g_vec[d] for d in range(2))
        self.opts = dict(
            n_iters=n_iters,
            infinite_gauge=infinite_gauge,
            nonoscillatory=nonoscillatory,
            third_order_terms=third_order_terms,
            bcs=(PERIODIC, PERIODIC),
        )

    def make_step(self, particulator):
        grid = self.grid
        opts = self.opts

        def step(sim):
            env = dict(sim["env"])
            ftype = env["pred_qv"].dtype
            g = jnp.asarray(self.g_factor, dtype=ftype)
            gc = tuple(jnp.asarray(c, dtype=ftype) for c in self.gc)
            for name in ("thd", "qv"):
                env[f"mpdata_{name}"] = mpdata_step(
                    env[f"pred_{name}"].reshape(grid), gc, g, **opts
                ).ravel()
            env["courant_0"] = jnp.asarray(self.courant[0], dtype=ftype).ravel()
            env["courant_1"] = jnp.asarray(self.courant[1], dtype=ftype).ravel()
            return {**sim, "env": env}

        return step


class MPDATA_1D:
    """single-column coupling (reference ``mpdata_1d.py``): one advectee
    (water vapour mixing ratio), time-dependent prescribed advector
    ``GC(t) = rho_times_w(t) * dt / dz`` at faces, g factor = rhod(z),
    extrapolated boundary conditions."""

    def __init__(
        self,
        *,
        nz,
        dt,
        advector_of_t,
        g_factor_z,
        g_factor_z_faces,
        n_iters=2,
        infinite_gauge=True,
        nonoscillatory=True,
        third_order_terms=False,
    ):
        self.nz = nz
        self.dt = dt
        self.advector_of_t = advector_of_t
        self.g_factor_z = np.asarray(g_factor_z, dtype=float)
        self.g_factor_z_faces = np.asarray(g_factor_z_faces, dtype=float)
        self.opts = dict(
            n_iters=n_iters,
            infinite_gauge=infinite_gauge,
            nonoscillatory=nonoscillatory,
            third_order_terms=third_order_terms,
            bcs=(EXTRAPOLATED,),
        )

    def make_step(self, particulator):
        dt = self.dt
        nz = self.nz
        adv_fn = self.advector_of_t
        opts = self.opts

        def step(sim):
            env = dict(sim["env"])
            ftype = env["pred_qv"].dtype
            g = jnp.asarray(self.g_factor_z, dtype=ftype)
            g_faces = jnp.asarray(self.g_factor_z_faces, dtype=ftype)
            t_mid = env["t"] + dt / 2
            gc = _eval_advector(adv_fn, t_mid, (nz + 1,), ftype)
            env["mpdata_qv"] = mpdata_step(env["pred_qv"], (gc,), g, **opts)
            env["mpdata_thd"] = env["pred_thd"]  # thd not advected in 1D
            env["courant_0"] = gc / g_faces
            return {**sim, "env": env}

        return step
