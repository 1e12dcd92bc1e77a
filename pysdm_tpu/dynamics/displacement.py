"""Displacement dynamic: particle advection by the flow + sedimentation
(parity: reference ``PySDM/dynamics/displacement.py``).

Design deltas: the adaptive substep count (reference
``upload_courant_field``, host-side doubling loop against the
``|delta courant| -> error`` estimate of Arabas et al. 2015 eqs. 13-16) is
computed *inside* the jitted step from the current courant fields, so
time-dependent advectors adapt per step with no host round trip; the substep
loop is a ``lax.fori_loop`` with a traced trip count. Courant fields are read
from the env state (keys ``courant_0..courant_{D-1}``), written there by the
EulerianAdvection dynamic or prescribed by the environment.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp

from ..ops import displacement as disp_ops

DEFAULTS = namedtuple("_", ("rtol", "adaptive"))(rtol=1e-2, adaptive=True)


def _migrate_z_phase(arrays, distributed, nz_local):
    """second exchange axis of the 2D (x, z) tile decomposition: classify
    the (still-unwrapped) z origin, wrap it tile-local, and ring-migrate
    along the z mesh axis (diagonal movers hop x first, then z)"""
    from ..parallel.migration import classify_dest_shift, migrate_ring

    multiplicity = arrays[0]
    cell_origin = arrays[3]
    dest_z, far_z = classify_dest_shift(
        cell_origin[-1], nz_local, multiplicity
    )
    multiplicity = jnp.where(far_z, 0, multiplicity)
    cell_origin = cell_origin.at[-1].set(cell_origin[-1] % nz_local)
    arrays = list(arrays)
    arrays[0] = multiplicity
    arrays[3] = cell_origin
    return migrate_ring(
        arrays=arrays,
        multiplicity_index=0,
        dest_shift=dest_z.astype(jnp.int32),
        axis_name=distributed["axis_name_z"],
        capacity=distributed["capacity"],
        rounds=distributed.get("rounds", 2),
    )


class Displacement:
    # moving particles between cells invalidates the cell-sorted state
    # invariant the shared-sort analysis tracks (builder.py)
    breaks_cell_sort = True

    def __init__(
        self,
        enable_sedimentation=False,
        precipitation_counting_level_index: int = 0,
        adaptive=DEFAULTS.adaptive,
        rtol=DEFAULTS.rtol,
        distributed_x: dict = None,
    ):
        """``distributed_x`` (multi-chip mode): dict(axis_name=<mesh axis>,
        capacity=<max migrations per step per direction>) — the grid's x axis
        is decomposed into per-device slabs; instead of the periodic x-wrap,
        slab-crossing particles are migrated to the ring neighbour
        (parallel.migration), and courant gathers use halo-extended fields."""
        self.particulator = None
        self.enable_sedimentation = enable_sedimentation
        self.precipitation_counting_level_index = precipitation_counting_level_index
        self.adaptive = adaptive
        self.rtol = rtol
        self.distributed_x = distributed_x

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("relative fall velocity")
        builder.add_flag("sedimentation_enable", self.enable_sedimentation)
        builder.add_counter("precipitated_mass", 1, None)
        builder.add_counter("max_n_substeps_displacement", 1, jnp.int32, fill=1)
        if self.distributed_x is not None:
            # [send_overflow, placement_overflow] breakdown (parallel/migration.py)
            builder.add_counter("migration_dropped", 2, jnp.int64)
            builder.add_counter("migration_far_moves", 1, jnp.int64)

    @property
    def precipitation_mass_in_last_step(self):
        return float(self.particulator.get_counter("precipitated_mass")[0])

    def make_step(self, particulator):
        mesh = particulator.mesh
        grid = mesh.grid
        n_dims = mesh.n_dims
        strides = mesh.strides.ravel()
        dt = particulator.dt
        dz = mesh.dz
        formulae = particulator.formulae
        resolver = particulator._resolver
        enable_sedimentation = self.enable_sedimentation
        precip_level = self.precipitation_counting_level_index
        adaptive = self.adaptive
        rtol = self.rtol
        distributed = self.distributed_x
        if distributed is None:
            courant_strides = tuple(
                disp_ops.face_strides(grid, d) for d in range(n_dims)
            )
        else:
            assert n_dims == 2, "distributed displacement: 2D (x, z) only"
            # courant fields get a 1-column halo on each decomposed side
            z_axis = distributed.get("axis_name_z")
            ext_grid = (
                grid[0] + 2,
                grid[1] + (2 if z_axis else 0),
            )
            courant_strides = tuple(
                disp_ops.face_strides(ext_grid, d) for d in range(n_dims)
            )
        # domain top in GLOBAL column coordinates (grid is the local tile)
        z_shards = (distributed or {}).get("z_shards", 1)
        domain_top = grid[-1] * z_shards

        def n_substeps_from_courant(
            courant, ftype, axis_name=None, axis_name_z=None
        ):
            """smallest power of two n with (d/n)/(1-d/n) < rtol where
            d = max |delta courant| (reference ``upload_courant_field``)"""
            d_max = jnp.zeros((), ftype)
            for d, c in enumerate(courant):
                d_max = jnp.maximum(d_max, jnp.max(jnp.abs(jnp.diff(c, axis=d))))
            if axis_name is not None:
                # the substep count must be a GLOBAL decision: a per-shard
                # max would give slabs different time resolutions and break
                # shard-count invariance (caught by the dryrun allclose)
                d_max = jax.lax.pmax(d_max, axis_name)
            if axis_name_z is not None:
                d_max = jax.lax.pmax(d_max, axis_name_z)

            def cond(n):
                x = d_max / n
                return x / (1.0 - x) >= rtol

            def body(n):
                return n * 2.0

            n = jax.lax.while_loop(cond, body, jnp.ones((), ftype))
            return n.astype(jnp.int32)

        def step(sim):
            particles = sim["particles"]
            env = sim["env"]
            counters = dict(sim["counters"])
            courant = tuple(
                env[f"courant_{d}"].reshape(
                    tuple(g + (1 if ax == d else 0) for ax, g in enumerate(grid))
                )
                for d in range(n_dims)
            )
            if distributed is not None:
                from ..parallel.halo import ring_halo_pad

                courant = tuple(
                    ring_halo_pad(c, 0, distributed["axis_name"]) for c in courant
                )
                if distributed.get("axis_name_z"):
                    courant = tuple(
                        ring_halo_pad(c, 1, distributed["axis_name_z"])
                        for c in courant
                    )
            ftype = courant[0].dtype
            if adaptive:
                n_sub = n_substeps_from_courant(
                    courant, ftype,
                    axis_name=(
                        distributed["axis_name"] if distributed else None
                    ),
                    axis_name_z=(
                        distributed.get("axis_name_z") if distributed else None
                    ),
                )
            else:
                n_sub = jnp.asarray(1, jnp.int32)
            n_sub_f = n_sub.astype(ftype)
            dt_sub = dt / n_sub_f

            if enable_sedimentation:
                # spin-up gate (reference SpinUp flips enable_sedimentation)
                v_fall = jnp.where(
                    sim["flags"]["sedimentation_enable"],
                    resolver.get(particles, "relative fall velocity"),
                    0.0,
                )
            else:
                v_fall = None

            if distributed is not None:
                z_halo = 1 if distributed.get("axis_name_z") else 0
                gather_offset = jnp.asarray(
                    [1, z_halo], dtype=jnp.int32
                )[:, None]
                # local z origins -> global column coordinates for the
                # precipitation/out-of-column flags on a z-decomposed mesh
                if z_halo:
                    z_off = jax.lax.axis_index(
                        distributed["axis_name_z"]
                    ).astype(jnp.int32) * grid[-1]
                else:
                    z_off = jnp.int32(0)
            else:
                gather_offset = jnp.zeros((n_dims, 1), dtype=jnp.int32)
                z_off = jnp.int32(0)

            def substep(_, carry):
                cell_origin, position_in_cell, multiplicity, rainfall = carry
                displacement = disp_ops.calculate_displacement(
                    formulae, courant, courant_strides,
                    cell_origin + gather_offset, position_in_cell, n_sub_f,
                )
                if enable_sedimentation:
                    # (reference Displacement.calculate_displacement tail):
                    # convert flow displacement to velocity, subtract fall
                    # speed, convert back to grid units
                    displacement = displacement.at[-1].add(
                        -v_fall * dt_sub / dz
                    )
                position_in_cell = position_in_cell + displacement
                if enable_sedimentation:
                    rain, multiplicity = disp_ops.flag_precipitated(
                        cell_origin=cell_origin,
                        position_in_cell=position_in_cell,
                        displacement=displacement,
                        multiplicity=multiplicity,
                        water_mass=particles.ext("signed water mass"),
                        precipitation_counting_level_index=precip_level,
                        z_offset=z_off,
                    )
                    # with sedimentation gated off, bottom-crossing particles
                    # still die (as via flag_out_of_column) but are not
                    # counted as precipitation
                    rainfall = rainfall + jnp.where(
                        sim["flags"]["sedimentation_enable"], rain, 0.0
                    )
                multiplicity = disp_ops.flag_out_of_column(
                    cell_origin=cell_origin,
                    position_in_cell=position_in_cell,
                    multiplicity=multiplicity,
                    domain_top_level_index=domain_top,
                    z_offset=z_off,
                )
                cell_origin, position_in_cell = disp_ops.update_cell_origin(
                    cell_origin, position_in_cell
                )
                if distributed is None:
                    cell_origin = disp_ops.periodic_boundary(cell_origin, grid)
                elif not distributed.get("axis_name_z"):
                    # x stays unwrapped (migration resolves slab crossings
                    # after the substep loop); wrap z as the reference does
                    z_wrapped = cell_origin[-1] % grid[-1]
                    cell_origin = cell_origin.at[-1].set(z_wrapped)
                # with z decomposed, z ALSO stays unwrapped: migration
                # classifies the tile crossing after the substep loop
                # (out-of-column crossers were killed above using global z)
                return cell_origin, position_in_cell, multiplicity, rainfall

            cell_origin, position_in_cell, multiplicity, rainfall = (
                jax.lax.fori_loop(
                    0,
                    n_sub,
                    substep,
                    (
                        particles.cell_origin,
                        particles.position_in_cell,
                        particles.multiplicity,
                        jnp.zeros((), ftype),
                    ),
                )
            )
            out_extra = {}
            if distributed is not None:
                from ..parallel.migration import (
                    classify_dest_shift,
                    migrate_ring,
                    migrate_ring_start,
                )

                nx_local = grid[0]
                nz_local = grid[-1]
                z_axis = distributed.get("axis_name_z")
                x = cell_origin[0]
                dest_shift, far = classify_dest_shift(
                    x, nx_local, multiplicity
                )
                if z_axis:
                    _, far_z = classify_dest_shift(
                        cell_origin[-1], nz_local, multiplicity
                    )
                    far = far | far_z
                # >1-tile movers cannot ride the ring exchange: kill + count
                multiplicity = jnp.where(far, 0, multiplicity)
                counters["migration_far_moves"] = counters[
                    "migration_far_moves"
                ] + jnp.sum(far).astype(jnp.int64).reshape(1)
                cell_origin = cell_origin.at[0].set(x % nx_local)
                # on a z-decomposed mesh the z origin stays UNWRAPPED through
                # the x exchange (it encodes the z destination); the z phase
                # below classifies + wraps it after x-arrivals are placed
                arrays = [
                    multiplicity,
                    particles.extensive,
                    particles.maximum,
                    cell_origin,
                    position_in_cell,
                ]
                if distributed.get("overlap", True):
                    # comm/compute overlap: issue the migration ppermutes
                    # and hand the in-flight buffers down the step — the
                    # following (cell-local) collision compute does not
                    # depend on them, so XLA overlaps the transfers; a
                    # MigrationCommit step (builder-appended after the last
                    # physics dynamic) places the arrivals
                    arrays, inflight = migrate_ring_start(
                        arrays=arrays,
                        multiplicity_index=0,
                        dest_shift=dest_shift.astype(jnp.int32),
                        axis_name=distributed["axis_name"],
                        capacity=distributed["capacity"],
                    )
                    out_extra["migration_inflight"] = inflight
                else:
                    arrays, n_dropped = migrate_ring(
                        arrays=arrays,
                        multiplicity_index=0,
                        dest_shift=dest_shift.astype(jnp.int32),
                        axis_name=distributed["axis_name"],
                        capacity=distributed["capacity"],
                        rounds=distributed.get("rounds", 2),
                    )
                    counters["migration_dropped"] = (
                        counters["migration_dropped"] + n_dropped
                    )
                    if z_axis:
                        arrays, n_dropped_z = _migrate_z_phase(
                            arrays, distributed, nz_local
                        )
                        counters["migration_dropped"] = (
                            counters["migration_dropped"] + n_dropped_z
                        )
                multiplicity, extensive, maximum, cell_origin, position_in_cell = (
                    arrays
                )
                particles = particles.replace(extensive=extensive, maximum=maximum)
            cell_id = disp_ops.recalculate_cell_id(cell_origin, strides)
            particles = particles.replace(
                cell_origin=cell_origin,
                position_in_cell=position_in_cell,
                multiplicity=multiplicity,
                cell_id=cell_id,
            )
            counters["precipitated_mass"] = rainfall.reshape(1)
            counters["max_n_substeps_displacement"] = jnp.maximum(
                counters["max_n_substeps_displacement"], n_sub.reshape(1)
            )
            return {
                **sim, "particles": particles, "counters": counters,
                **out_extra,
            }

        return step

    def make_commit_step(self, particulator):
        """overlap mode: place the in-flight migration arrivals started by
        this dynamic's step (builder appends this AFTER the last physics
        dynamic so the ppermutes overlap the collision compute). Arrivals
        scatter into grave slots, so this step breaks the cell-sorted
        invariant (declared via breaks_cell_sort on the class — the
        shared-sort fixpoint accounts for it)."""
        distributed = self.distributed_x
        if distributed is None or not distributed.get("overlap", True):
            return None
        strides = particulator.mesh.strides.ravel()

        def commit(sim):
            from ..ops import displacement as disp_ops
            from ..parallel.migration import migrate_ring_commit

            sim = dict(sim)
            inflight = sim.pop("migration_inflight")
            particles = sim["particles"]
            counters = dict(sim["counters"])
            arrays = [
                particles.multiplicity,
                particles.extensive,
                particles.maximum,
                particles.cell_origin,
                particles.position_in_cell,
            ]
            arrays, n_dropped = migrate_ring_commit(
                arrays=arrays,
                inflight=inflight,
                multiplicity_index=0,
                axis_name=distributed["axis_name"],
                capacity=distributed["capacity"],
                rounds=distributed.get("rounds", 2),
            )
            if distributed.get("axis_name_z"):
                arrays, n_dropped_z = _migrate_z_phase(
                    arrays, distributed, particulator.mesh.grid[-1]
                )
                n_dropped = n_dropped + n_dropped_z
            multiplicity, extensive, maximum, cell_origin, position_in_cell = (
                arrays
            )
            cell_id = disp_ops.recalculate_cell_id(cell_origin, strides)
            counters["migration_dropped"] = (
                counters["migration_dropped"] + n_dropped
            )
            particles = particles.replace(
                multiplicity=multiplicity,
                extensive=extensive,
                maximum=maximum,
                cell_origin=cell_origin,
                position_in_cell=position_in_cell,
                cell_id=cell_id,
            )
            return {**sim, "particles": particles, "counters": counters}

        return commit
