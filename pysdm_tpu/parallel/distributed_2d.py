"""Multi-chip 2D kinematic simulation: x-slab domain decomposition.

The genuinely new layer vs the single-device reference (SURVEY.md §2.5/§7
delta #8): the (x, z) domain is decomposed into per-device x-slabs over a 1D
device mesh; Eulerian fields advect with ring-halo-exchange MPDATA
(parallel.halo), super-droplets are owned by their slab and migrate via
fixed-capacity ppermute buffers after displacement (parallel.migration),
while condensation and collisions are cell-local and need no communication.
The per-shard step is the ordinary single-chip composed step (built by the
standard Builder against the local mesh) wrapped in ``shard_map``.

Works identically on real GPUs and on the emulated CPU device mesh
(``xla_force_host_platform_device_count``) — the testing analogue of the
reference's FakeThrustRTC."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

if hasattr(jax, "shard_map"):  # jax >= 0.8
    shard_map = jax.shard_map
else:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..backends import CPU
from ..builder import Builder
from ..dynamics import (
    AmbientThermodynamics,
    Coalescence,
    Condensation,
    Displacement,
    EulerianAdvection,
)
from ..dynamics.eulerian_advection import MPDATA_2D
from ..environments.kinematic_2d import Kinematic2D
from ..impl import arakawa_c
from ..initialisation.sampling.spatial_sampling import Pseudorandom
from ..ops.mpdata import mpdata_step


class DistributedMPDATA_2D(MPDATA_2D):
    """MPDATA_2D whose step runs on the local slab: the (precomputed global)
    advector is sliced by the shard index and the x boundary condition is the
    ring halo exchange"""

    def __init__(self, *, axis_name, n_shards, axis_name_z="z",
                 n_shards_z=1, **kwargs):
        super().__init__(**kwargs)
        self.axis_name = axis_name
        self.axis_name_z = axis_name_z
        self.n_shards = n_shards
        self.n_shards_z = n_shards_z
        self.opts["bcs"] = (
            ("shard", axis_name),
            ("shard", axis_name_z) if n_shards_z > 1 else "periodic",
        )

    def local_gc(self, x_idx, z_idx, ftype):
        """tile slice of the global advector: x-faces (nxl+1, nzl) overlap
        between x-neighbours; z-faces (nxl, nzl+1) between z-neighbours"""
        nx, nz = self.grid
        nxl = nx // self.n_shards
        nzl = nz // self.n_shards_z
        gc_x = jnp.asarray(self.gc[0], dtype=ftype)
        gc_z = jnp.asarray(self.gc[1], dtype=ftype)
        x0 = x_idx.astype(jnp.int32) * nxl
        z0 = z_idx.astype(jnp.int32) * nzl
        return (
            jax.lax.dynamic_slice(gc_x, (x0, z0), (nxl + 1, nzl)),
            jax.lax.dynamic_slice(gc_z, (x0, z0), (nxl, nzl + 1)),
        )

    def make_step(self, particulator):
        nx, nz = self.grid
        nxl = nx // self.n_shards
        nzl = nz // self.n_shards_z
        opts = self.opts
        axis_name = self.axis_name
        axis_name_z = self.axis_name_z

        def step(sim):
            env = dict(sim["env"])
            ftype = env["pred_qv"].dtype
            idx = jax.lax.axis_index(axis_name)
            z_idx = (
                jax.lax.axis_index(axis_name_z)
                if self.n_shards_z > 1
                else jnp.int32(0)
            )
            gc = self.local_gc(idx, z_idx, ftype)
            g_full = jnp.asarray(self.g_factor, dtype=ftype)  # x-uniform
            z0 = z_idx.astype(jnp.int32) * nzl
            g = jax.lax.dynamic_slice(
                g_full[:nxl], (jnp.int32(0), z0), (nxl, nzl)
            )
            for name in ("thd", "qv"):
                env[f"mpdata_{name}"] = mpdata_step(
                    env[f"pred_{name}"].reshape((nxl, nzl)), gc, g, **opts
                ).ravel()
            courant_x = jnp.asarray(self.courant[0], dtype=ftype)
            courant_z = jnp.asarray(self.courant[1], dtype=ftype)
            x0 = idx.astype(jnp.int32) * nxl
            env["courant_0"] = jax.lax.dynamic_slice(
                courant_x, (x0, z0), (nxl + 1, nzl)
            ).ravel()
            env["courant_1"] = jax.lax.dynamic_slice(
                courant_z, (x0, z0), (nxl, nzl + 1)
            ).ravel()
            return {**sim, "env": env}

        return step


def _assign_particles_to_shards(
    attributes, n_shards, nx_local, capacity, nz_local=None, sz=1
):
    """split globally-sampled particles into per-tile fixed-capacity blocks,
    converting cell origins to tile-local coordinates (shard index =
    x_tile * sz + z_tile, matching the ("x","z") device-mesh order); dead
    padding slots get multiplicity 0 (and epsilon dry volumes to keep
    derived attributes finite)"""
    cell_origin = np.asarray(attributes["cell origin"])
    if sz > 1:
        shard_of = (cell_origin[0] // nx_local) * sz + (
            cell_origin[1] // nz_local
        )
    else:
        shard_of = cell_origin[0] // nx_local
    out = {k: [] for k in attributes}
    for s in range(n_shards):
        sel = np.nonzero(shard_of == s)[0]
        if len(sel) > capacity:
            raise ValueError(
                f"shard {s}: {len(sel)} particles > capacity {capacity}"
            )
        pad = capacity - len(sel)
        for key, value in attributes.items():
            v = np.asarray(value)
            taken = v[..., sel]
            if key == "multiplicity":
                filler = np.zeros((pad,), dtype=v.dtype)
            elif key == "cell origin":
                filler = np.zeros((v.shape[0], pad), dtype=v.dtype)
            elif key in ("dry volume", "kappa times dry volume"):
                filler = np.full((pad,), 1e-25)
            elif key == "water mass":
                filler = np.zeros((pad,))  # 0 -> inert in the implicit solver
            else:
                filler = np.zeros(taken.shape[:-1] + (pad,), dtype=v.dtype)
            if key == "cell origin":
                taken = taken.copy()
                if sz > 1:
                    taken[0] -= (s // sz) * nx_local
                    taken[1] -= (s % sz) * nz_local
                else:
                    taken[0] -= s * nx_local
            out[key].append(np.concatenate([taken, filler], axis=-1))
    return {k: np.concatenate(v, axis=-1) for k, v in out.items()}


class DistributedSimulation2D:
    """Arabas-2015-style 2D warm-rain case decomposed over an ("x",) device
    mesh. API: run(steps), get_env(key) (global field), attributes (global)."""

    def __init__(
        self,
        settings,
        *,
        n_shards=None,
        mesh_shape=None,
        backend_class=CPU,
        capacity_factor=2.0,
        migration_capacity=None,
        migration_overlap=True,
        axis_name="x",
        axis_name_z="z",
    ):
        devices = jax.devices()
        if mesh_shape is not None:
            sx, sz = mesh_shape
            n_shards = sx * sz
        else:
            n_shards = n_shards or len(devices)
            sx, sz = n_shards, 1
        nx, nz = settings.grid
        assert nx % sx == 0, "nx must divide the x shard count"
        assert nz % sz == 0, "nz must divide the z shard count"
        nxl = nx // sx
        nzl = nz // sz
        self.n_shards = n_shards
        self.mesh_shape = (sx, sz)
        self.axis_name = axis_name
        self.axis_name_z = axis_name_z
        self.settings = settings
        self.jmesh = JaxMesh(
            np.array(devices[:n_shards]).reshape(sx, sz),
            axis_names=(axis_name, axis_name_z),
        )

        n_sd_global = settings.n_sd
        capacity = int(capacity_factor * n_sd_global / n_shards)
        migration_capacity = migration_capacity or max(64, capacity // 8)

        # ---- local template simulation (per-shard mesh + dynamics) --------
        backend = backend_class(formulae=settings.formulae)
        environment = Kinematic2D(
            dt=settings.dt,
            grid=(nxl, nzl),
            size=(settings.size[0] / sx, settings.size[1] / sz),
            rhod_of=settings.rhod_of_zZ,
        )
        builder = Builder(n_sd=capacity, backend=backend, environment=environment)
        builder.add_dynamic(AmbientThermodynamics())
        builder.add_dynamic(Condensation(adaptive=settings.condensation_adaptive))
        # local-slab advectee fields (profiles are x-uniform, so every slab
        # starts from the same columns); the advector stays global and is
        # sliced per shard inside the step
        advectees = {
            "th": np.repeat(
                settings.initial_dry_potential_temperature_profile[:nzl]
                .reshape(1, -1),
                nxl, axis=0,
            ),
            "water_vapour_mixing_ratio": np.repeat(
                settings.initial_vapour_mixing_ratio_profile[:nzl]
                .reshape(1, -1),
                nxl, axis=0,
            ),
        }
        solver = DistributedMPDATA_2D(
            axis_name=axis_name,
            axis_name_z=axis_name_z,
            n_shards=sx,
            n_shards_z=sz,
            advectees=advectees,
            stream_function=settings.stream_function,
            rhod_of_zZ=settings.rhod_of_zZ,
            dt=settings.dt,
            grid=settings.grid,  # global grid: advector built once, sliced per shard
            size=settings.size,
            n_iters=settings.mpdata_iters,
            infinite_gauge=settings.mpdata_iga,
            nonoscillatory=settings.mpdata_fct,
        )
        builder.add_dynamic(EulerianAdvection(solver))
        builder.add_dynamic(
            Displacement(
                enable_sedimentation=True,
                distributed_x=dict(
                    axis_name=axis_name, capacity=migration_capacity,
                    overlap=migration_overlap,
                    axis_name_z=axis_name_z if sz > 1 else None,
                    z_shards=sz,
                ),
            )
        )
        builder.add_dynamic(
            Coalescence(
                collision_kernel=settings.kernel,
                adaptive=settings.coalescence_adaptive,
            )
        )

        # ---- global initial attributes, assigned to slabs -----------------
        positions = Pseudorandom.sample(
            grid=settings.grid, n_sd=n_sd_global, seed=settings.formulae.seed
        )
        global_env = Kinematic2D(
            dt=settings.dt, grid=settings.grid, size=settings.size,
            rhod_of=settings.rhod_of_zZ,
        )
        # reuse the template particulator for formulae access; initial fields
        # are the global x-uniform profiles (instance attr shadows the
        # solver-backed method)
        global_env.particulator = builder.particulator
        global_env.formulae = settings.formulae
        thd_glob = np.repeat(
            settings.initial_dry_potential_temperature_profile.reshape(1, -1),
            nx, axis=0,
        ).ravel()
        qv_glob = np.repeat(
            settings.initial_vapour_mixing_ratio_profile.reshape(1, -1),
            nx, axis=0,
        ).ravel()
        global_env._initial_fields = lambda: (thd_glob, qv_glob)
        global_mesh_attrs = global_env.init_attributes(
            spatial_discretisation=_Precomputed(positions),
            dry_radius_spectrum=settings.spectrum_per_mass_of_dry_air,
            kappa=settings.kappa,
            n_sd=n_sd_global,
            seed=settings.formulae.seed,
        )
        sharded_attrs = _assign_particles_to_shards(
            global_mesh_attrs, n_shards, nxl, capacity, nz_local=nzl, sz=sz
        )
        # build with shard-0's block to fix shapes, then overwrite state
        template_attrs = {
            k: np.asarray(v)[..., :capacity] for k, v in sharded_attrs.items()
        }
        # pre-round so dead padding slots (multiplicity 0) pass the builder's
        # float-discretisation zero guard
        template_attrs["multiplicity"] = (
            template_attrs["multiplicity"].round().astype(np.int64)
        )
        self.particulator = builder.build(template_attrs)
        p = self.particulator

        # ---- stacked global state -----------------------------------------
        from ..impl.state import make_particle_state

        full = make_particle_state(
            multiplicity=sharded_attrs["multiplicity"].round().astype(np.int64),
            extensive={
                name: np.asarray(
                    {
                        "signed water mass": sharded_attrs["water mass"],
                        "dry volume": sharded_attrs["dry volume"],
                        "kappa times dry volume": sharded_attrs[
                            "kappa times dry volume"
                        ],
                    }[name]
                )
                for name in p.particles.ext_names
            },
            maximum={},
            cell_id=None,
            cell_origin=sharded_attrs["cell origin"],
            position_in_cell=sharded_attrs["position in cell"],
            mult_dtype=p.mult_dtype,
            dtype=p.dtype,
        )
        local_strides = environment.mesh.strides.ravel()
        cell_id = (
            local_strides[:, None] * np.asarray(full.cell_origin)
        ).sum(axis=0).astype(np.int32)
        full = full.replace(cell_id=jnp.asarray(cell_id))
        # each shard block must satisfy the builder's cell-sorted invariant
        # (dead padding trailing): the template build pre-sorted only ITS
        # state; this stacked global state replaces it, and a following
        # Condensation may skip its sort on the strength of that invariant
        # (shared-sort analysis, builder.py)
        n_cell_local = nxl * nzl
        order = np.empty(n_shards * capacity, dtype=np.int64)
        mult_np = np.asarray(full.multiplicity)
        alive_np = mult_np > 0
        for s in range(n_shards):
            lo = s * capacity
            key = np.where(
                alive_np[lo : lo + capacity],
                cell_id[lo : lo + capacity],
                n_cell_local,
            )
            order[lo : lo + capacity] = lo + np.argsort(key, kind="stable")
        order_j = jnp.asarray(order)
        full = jax.tree_util.tree_map(
            lambda a: a[..., order_j] if a.ndim and a.shape[-1] == order.size
            else a,
            full,
        )
        # dead padding must read cell_id n_cell-1 so the sorted cell_id row
        # stays ascending (the bucket-shuffle steady-state convention,
        # ops/segments.py reconstruct_cell_rows) — searchsorted on a
        # non-monotonic row yields garbage segment starts, which the
        # shard-count-invariance test caught as shard-dependent condensation
        # substep counts
        full = full.replace(
            cell_id=jnp.where(
                jnp.asarray(alive_np)[order_j],
                full.cell_id,
                jnp.asarray(n_cell_local - 1, full.cell_id.dtype),
            )
        )

        env0 = p.sim_state["env"]
        if sz > 1:
            # z tiles have DIFFERENT initial profiles: build the global env
            # once and slice per tile (the template env0 only covers tile
            # (0,0)); face-shaped entries (courant) fall back to the tiled
            # template values — the advection step overwrites them before
            # displacement reads them
            genv = global_env.init_env_state(p.dtype)
            n_cell_global = nx * nz

            def _tile_blocks(vg):
                a = np.asarray(vg).reshape(nx, nz)
                blocks = [
                    a[i * nxl:(i + 1) * nxl, j * nzl:(j + 1) * nzl].ravel()
                    for i in range(sx) for j in range(sz)
                ]
                return jnp.asarray(np.concatenate(blocks), dtype=p.dtype)

            env = {}
            for k, v in env0.items():
                vg = genv.get(k)
                if (
                    vg is not None
                    and getattr(vg, "ndim", 0) == 1
                    and vg.shape[0] == n_cell_global
                ):
                    env[k] = _tile_blocks(vg)
                elif v.ndim:
                    env[k] = jnp.tile(v, (n_shards,) + (1,) * (v.ndim - 1))
                else:
                    env[k] = jnp.tile(v.reshape(1), n_shards)
        else:
            env = {
                k: jnp.tile(v, (n_shards,) + (1,) * (v.ndim - 1)) if v.ndim
                else jnp.tile(v.reshape(1), n_shards)
                for k, v in env0.items()
            }
        counters = {
            k: jnp.tile(v, n_shards) for k, v in p.sim_state["counters"].items()
        }
        keys = jax.random.split(
            jax.random.PRNGKey(settings.formulae.seed), n_shards
        )
        self_sim = {
            "particles": full,
            "env": env,
            "counters": counters,
            "flags": p.sim_state["flags"],
            "key": keys,
        }
        spec = self._sim_spec(self_sim)
        # place the host-replicated initial state as global arrays — on a
        # process-spanning mesh (multi-host via parallel.multihost.initialize)
        # each process donates its addressable slab blocks
        from .multihost import host_replicated_to_global

        p.sim_state = host_replicated_to_global(self_sim, spec, self.jmesh)

        # ---- shard_map-wrapped step ----------------------------------------
        raw_step = p._step_fn_raw

        def local_step(sim):
            sim = {**sim, "key": sim["key"][0],
                   "env": {**sim["env"], "t": sim["env"]["t"][0]}}
            out = raw_step(sim)
            return {**out, "key": out["key"][None],
                    "env": {**out["env"], "t": out["env"]["t"][None]}}

        sharded = shard_map(
            local_step, mesh=self.jmesh, in_specs=(spec,), out_specs=spec,
            check_vma=False,
        )
        p._step_fn = jax.jit(sharded)
        p._multi_step_fn = jax.jit(
            lambda sim, n: jax.lax.fori_loop(0, n, lambda _, s: sharded(s), sim)
        )
        self.n_cell_local = nxl * nzl

    def _sim_spec(self, sim):
        axes = (self.axis_name, self.axis_name_z)
        particles = sim["particles"].replace(
            multiplicity=P(axes),
            extensive=P(None, axes),
            maximum=P(None, axes),
            cell_id=P(axes),
            cell_origin=P(None, axes),
            position_in_cell=P(None, axes),
        )
        return {
            "particles": particles,
            "env": {k: P(axes) for k in sim["env"]},
            "counters": {k: P(axes) for k in sim["counters"]},
            "flags": {k: P() for k in sim["flags"]},
            "key": P(axes),
        }

    # ---- host-side access ------------------------------------------------
    def run(self, steps):
        self.particulator.run(steps)

    def get_env(self, key):
        """global field reassembled to (nx, nz) layout from the per-tile
        blocks. Single-process only — on a multi-host mesh the global array
        is not fully addressable; use :meth:`global_diagnostics` instead."""
        v = np.asarray(self.particulator.sim_state["env"][key])
        sx, sz = self.mesh_shape
        if v.ndim == 1 and v.size == self.n_shards * self.n_cell_local:
            nx, nz = self.settings.grid
            nxl, nzl = nx // sx, nz // sz
            return (
                v.reshape(sx, sz, nxl, nzl)
                .transpose(0, 2, 1, 3)
                .reshape(nx, nz)
            )
        return v

    def global_diagnostics(self):
        """global scalar diagnostics, computed on-device with a replicated
        output so every process can read them (the multi-host-safe
        counterpart of the np.asarray getters): water budget terms
        (vapour + liquid + precipitated = conserved total), alive count,
        dropped-migration count."""
        import functools

        from jax.sharding import NamedSharding

        p = self.particulator
        dv = p.mesh.dv

        @functools.partial(
            jax.jit,
            out_shardings=NamedSharding(self.jmesh, P()),
        )
        def diag(sim):
            env = sim["env"]
            parts = sim["particles"]
            ftype = env["qv"].dtype
            vapour = jnp.sum(env["rhod"] * env["qv"]) * dv
            liquid = jnp.sum(
                parts.multiplicity.astype(ftype)
                * jnp.abs(parts.ext("signed water mass"))
            )
            precip = jnp.sum(sim["counters"]["precipitated_mass"])
            return {
                "water_vapour": vapour,
                "water_liquid": liquid,
                "water_precipitated": precip,
                "water_total": vapour + liquid + precip,
                "n_alive": jnp.sum(parts.multiplicity > 0),
                "migration_dropped": jnp.sum(
                    sim["counters"]["migration_dropped"]
                ),
                "condensation_ok": jnp.all(
                    sim["counters"]["condensation_success"]
                ),
            }

        return {k: float(v) for k, v in diag(p.sim_state).items()}

    @property
    def attributes(self):
        return self.particulator.attributes

    def global_cell_id(self):
        """cell ids in global flat (x-major) coordinates"""
        local = np.asarray(self.particulator.particles.cell_id)
        n = local.shape[0] // self.n_shards
        shard = np.arange(local.shape[0]) // n
        sx, sz = self.mesh_shape
        nx, nz = self.settings.grid
        nxl, nzl = nx // sx, nz // sz
        x_loc = local // nzl
        z_loc = local % nzl
        gx = (shard // sz) * nxl + x_loc
        gz = (shard % sz) * nzl + z_loc
        return gx * nz + gz


class _Precomputed:
    """spatial-sampling shim returning precomputed positions"""

    def __init__(self, positions):
        self.positions = positions

    def sample(self, **kwargs):
        return self.positions
