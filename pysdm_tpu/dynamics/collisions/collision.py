"""Collision dynamic: SDM Monte-Carlo coalescence (and breakup, stage 7).

Orchestration parity with reference ``PySDM/dynamics/collisions/collision.py``;
Re-design of the step itself (SURVEY.md §7 deltas #3/#4): the whole
substep — croupier shuffle, pairing, kernel evaluation, Shima-eq.20
normalization, gamma draw, coalescence update, rate bookkeeping — is one fused
vectorized trace over the particle axis; the adaptive per-cell ``dt_left`` loop
is a ``lax.while_loop`` over the full (static-shape) state with spent cells
masked to probability zero, replacing the reference's working-length cuts.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp

from ...impl.attributes import AttributeResolver
from ...ops import collisions as coll_ops
from ...ops import segments as seg_ops
from .coalescence_efficiencies import ConstEc
from .breakup_efficiencies import ConstEb
from .breakup_fragmentations import AlwaysN

DEFAULTS = namedtuple("_", ("dt_coal_range", "adaptive", "substeps", "max_multiplicity"))(
    dt_coal_range=(0.1, 100.0),
    adaptive=True,
    substeps=1,
    max_multiplicity=2**63 // int(2e5),
)


class Collision:
    # the bucket-shuffle croupier leaves the state cell-sorted (multi-cell
    # path), re-establishing the invariant for a following Condensation
    restores_cell_sort = True

    def __init__(
        self,
        *,
        collision_kernel,
        coalescence_efficiency,
        breakup_efficiency,
        fragmentation_function,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
        enable_breakup: bool = True,
        warn_overflows: bool = True,
    ):
        assert substeps == 1 or adaptive is False
        assert dt_coal_range[0] > 0
        self.particulator = None
        self.enable = True
        self.enable_breakup = enable_breakup
        self.warn_overflows = warn_overflows
        self.max_multiplicity = DEFAULTS.max_multiplicity
        self.collision_kernel = collision_kernel
        self.compute_coalescence_efficiency = coalescence_efficiency
        self.compute_breakup_efficiency = breakup_efficiency
        self.compute_number_of_fragments = fragmentation_function
        self.croupier = croupier  # accepted for API parity; sort-croupier always
        self.optimized_random = optimized_random
        self.substeps = substeps
        self.adaptive = adaptive
        self.dt_coal_range = tuple(dt_coal_range)

    def register(self, builder):
        self.particulator = builder.particulator
        if self.particulator.n_sd < 2:
            raise ValueError("No one to collide with!")
        if self.dt_coal_range[1] > self.particulator.dt:
            self.dt_coal_range = (self.dt_coal_range[0], self.particulator.dt)
        assert self.dt_coal_range[0] <= self.dt_coal_range[1]
        self.collision_kernel.register(builder)
        if self.enable_breakup:
            self.compute_coalescence_efficiency.register(builder)
            self.compute_breakup_efficiency.register(builder)
            self.compute_number_of_fragments.register(builder)
        self.u01_injection = builder.u01_injection
        if self.u01_injection:
            if self.adaptive or self.substeps != 1:
                raise ValueError(
                    "u01 injection requires adaptive=False, substeps=1 "
                    "(one injected stream per purpose per step)"
                )
            for purpose in (
                "collision_shuffle",
                "collision_gamma",
                "collision_process",
                "collision_fragmentation",
            ):
                builder.add_u01_purpose(purpose)
        n_cell = self.particulator.mesh.n_cell
        ftype = self.particulator.dtype
        # rate counters share the multiplicity dtype (int64, or f64 when
        # multiplicities are stored as exact floats — see ops.collisions)
        rate_dtype = self.particulator.mult_dtype
        builder.add_flag("collision_enable", self.enable)
        builder.add_counter("collision_rate", n_cell, rate_dtype)
        # running totals accumulate in f64 (the per-step sums are f32 for
        # speed — the sentinel below bounds THEIR error — but adding f32
        # step sums into an f32 total drifts once totals pass 2^24;
        # per-cell counter arrays are tiny, so f64 accumulation is free)
        builder.add_counter("collision_rate_deficit", n_cell, jnp.float64)
        builder.add_counter("coalescence_rate", n_cell, rate_dtype)
        builder.add_counter("collision_n_substep", n_cell, jnp.int32)
        # precision sentinel: largest single-step per-cell rate sum observed
        # (sums beyond 2^24 are no longer exact in the f32 accumulation
        # pipeline — reference uses exact i64 atomics; see
        # ops.collisions.accumulate_counter)
        builder.add_counter("rate_step_sum_max", 1, jnp.float32)
        if self.enable_breakup:
            builder.add_counter("breakup_rate", n_cell, jnp.float64)
            builder.add_counter("breakup_rate_deficit", n_cell, jnp.float64)

    def make_step(self, particulator):
        mesh = particulator.mesh
        n_cell = mesh.n_cell
        dt = particulator.dt
        formulae = particulator.formulae
        resolver = AttributeResolver(formulae)
        kernel = self.collision_kernel
        adaptive = self.adaptive
        substeps = self.substeps
        dt_range = self.dt_coal_range
        enable_breakup = self.enable_breakup
        ftype = particulator.dtype
        if enable_breakup:
            frag = self.compute_number_of_fragments
            ec_fn = self.compute_coalescence_efficiency
            eb_fn = self.compute_breakup_efficiency
            max_multiplicity = self.max_multiplicity
            handle_all = formulae.handle_all_breakups

        u01_injection = getattr(self, "u01_injection", False)
        # sort-free mirror croupier (ops/pairing.py): single-cell domains
        # (0D box / parcel) pair slot o with (K - o) mod N via flip+roll —
        # removes the bucket-shuffle sort entirely. The sort croupier
        # remains for multi-cell domains, for u01-injection parity mode, and
        # on explicit request (croupier="sort").
        use_mirror = (
            n_cell == 1 and not u01_injection and self.croupier != "sort"
        )

        def substep(particles, env, counters, key, dt_left, prob_scale,
                    injected=None):
            n_sd = particles.n_sd
            key, k_sh, k_gam, k_proc, k_frag = jax.random.split(key, 5)

            def draw(purpose, k):
                if injected is not None:
                    return injected[purpose]
                return jax.random.uniform(k, (n_sd,), dtype=ftype)

            if use_mirror:
                from ...ops.pairing import MirrorPairing

                K = jax.random.randint(k_sh, (), 0, n_sd, dtype=jnp.int32)
                pairing = MirrorPairing(K, n_sd, particles.alive)
                sorted_cell = None
                cell_start = None
                is_first = pairing.is_first
            else:
                pairing = None
                if injected is not None:
                    u_sh = injected["collision_shuffle"]
                else:
                    # raw bits: the packed-key shuffle consumes uint32 directly
                    u_sh = jax.random.bits(k_sh, (n_sd,), jnp.uint32)
                # one variadic sort carries the whole state as payload
                # operands and the state stays in sorted order afterwards
                (
                    particles,
                    sorted_cell,
                    cell_start,
                    is_first,
                ) = seg_ops.bucket_shuffle_state(particles, u_sh, n_cell, mesh)
            attr_names = set(kernel.required_attributes)
            if enable_breakup:
                attr_names |= set(getattr(frag, "required_attributes", ()))
                attr_names |= set(getattr(ec_fn, "required_attributes", ()))
                attr_names |= set(getattr(eb_fn, "required_attributes", ()))
            attrs_a = {
                name: resolver.get(particles, name) for name in sorted(attr_names)
            }
            if use_mirror:
                attrs_b = {
                    name: pairing.partner(v) for name, v in attrs_a.items()
                }
            else:
                attrs_b = {
                    name: seg_ops.pair_roll(v) for name, v in attrs_a.items()
                }
            kernel_vals = kernel.pairwise(formulae, attrs_a, attrs_b)

            mult_s = particles.multiplicity
            ext_s = particles.extensive

            dv = env.get("dv", mesh.dv)
            if use_mirror:
                norm = coll_ops.mirror_normalization_factor(dt, dv, n_sd, ftype)
            else:
                norm = coll_ops.normalization_factor(
                    cell_start, dt, dv, n_cell, ftype
                )
            prob = coll_ops.collision_probability(
                kernel_vals.astype(ftype), mult_s, sorted_cell, norm, is_first,
                pairing=pairing,
            )
            if adaptive:
                (
                    prob,
                    dt_left,
                    counters["collision_n_substep"],
                    _,
                ) = coll_ops.scale_prob_adaptive(
                    prob=prob,
                    mult_s=mult_s,
                    sorted_cell=sorted_cell,
                    cell_start=cell_start,
                    is_first=is_first,
                    dt_left=dt_left,
                    dt=dt,
                    dt_range=dt_range,
                    n_cell=n_cell,
                    stats_n_substep=counters["collision_n_substep"],
                    pairing=pairing,
                )
            else:
                prob = prob * prob_scale

            rand = draw("collision_gamma", k_gam)

            gamma, counters = coll_ops.compute_gamma(
                prob, rand, mult_s, sorted_cell, is_first, n_cell, counters,
                cell_start=cell_start, pairing=pairing,
            )

            if not enable_breakup:
                if particles.maximum.shape[0]:
                    mult_s, ext_s, counters, max_s = coll_ops.coalesce(
                        mult_s, ext_s, gamma, is_first, sorted_cell, n_cell,
                        counters, cell_start=cell_start,
                        max_s=particles.maximum, pairing=pairing,
                    )
                    particles = particles.replace(maximum=max_s)
                else:
                    mult_s, ext_s, counters = coll_ops.coalesce(
                        mult_s, ext_s, gamma, is_first, sorted_cell, n_cell,
                        counters, cell_start=cell_start, pairing=pairing,
                    )
            else:
                from ...ops.breakup import collision_coalescence_breakup

                u_proc = draw("collision_process", k_proc)
                u_frag = draw("collision_fragmentation", k_frag)
                Ec = ec_fn.pairwise(formulae, attrs_a, attrs_b)
                Eb = eb_fn.pairwise(formulae, attrs_a, attrs_b)
                n_fragment, fragment_mass = frag.pairwise(
                    formulae, attrs_a, attrs_b, u_frag
                )
                mult_s, ext_s, counters = collision_coalescence_breakup(
                    mult_s=mult_s,
                    ext_s=ext_s,
                    ext_names=particles.ext_names,
                    gamma=gamma,
                    rand=u_proc,
                    Ec=Ec,
                    Eb=Eb,
                    fragment_mass=fragment_mass,
                    is_first=is_first,
                    sorted_cell=sorted_cell,
                    cell_start=cell_start,
                    n_cell=n_cell,
                    counters=counters,
                    max_multiplicity=max_multiplicity,
                    handle_all_breakups=handle_all,
                    formulae=formulae,
                    pairing=pairing,
                )

            particles = particles.replace(multiplicity=mult_s, extensive=ext_s)
            return particles, counters, key, dt_left

        sort_when_disabled = getattr(self, "_sort_when_disabled", False)

        def _disabled_step(sim):
            # when a downstream dynamic relies on this dynamic's sort
            # (shared-sort invariant, builder.py), the spin-up-disabled
            # branch must still leave the state cell-sorted — a stable
            # cell sort, no physics (same per-step sort count as before
            # the shared-sort optimization: the consumer's own sort moved
            # here)
            if not sort_when_disabled or n_cell == 1:
                return sim
            p2, _, _ = seg_ops.sort_state_by_cell(
                sim["particles"], n_cell, mesh
            )
            return {**sim, "particles": p2}

        def step(sim):
            # spin-up gate (reference Arabas-2015 SpinUp flips
            # Collision.enable): traced flag, no recompilation on toggle
            return jax.lax.cond(
                sim["flags"]["collision_enable"], _enabled_step,
                _disabled_step, sim,
            )

        def _enabled_step(sim):
            particles = sim["particles"]
            counters = sim["counters"]
            key = sim["key"]
            env = sim["env"]
            if not adaptive:
                dt_left = jnp.zeros((n_cell,), ftype)
                injected = sim.get("u01") if u01_injection else None
                for _ in range(substeps):
                    particles, counters, key, dt_left = substep(
                        particles, env, counters, key, dt_left,
                        1.0 / substeps, injected=injected,
                    )
            else:
                dt_left0 = jnp.full((n_cell,), dt, dtype=ftype)

                def cond(carry):
                    _, _, _, dt_left = carry
                    return jnp.any(dt_left > 0)

                def body(carry):
                    particles, counters, key, dt_left = carry
                    return substep(particles, env, counters, key, dt_left, 1.0)

                particles, counters, key, _ = jax.lax.while_loop(
                    cond, body, (particles, counters, key, dt_left0)
                )
            return {**sim, "particles": particles, "counters": counters, "key": key}

        return step


class Coalescence(Collision):
    def __init__(
        self,
        *,
        collision_kernel,
        coalescence_efficiency=None,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
    ):
        super().__init__(
            collision_kernel=collision_kernel,
            coalescence_efficiency=coalescence_efficiency or ConstEc(Ec=1),
            breakup_efficiency=ConstEb(Eb=0),
            fragmentation_function=AlwaysN(n=1),
            croupier=croupier,
            optimized_random=optimized_random,
            substeps=substeps,
            adaptive=adaptive,
            dt_coal_range=dt_coal_range,
            enable_breakup=False,
        )


class Breakup(Collision):
    def __init__(
        self,
        *,
        collision_kernel,
        fragmentation_function,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
        warn_overflows=True,
    ):
        super().__init__(
            collision_kernel=collision_kernel,
            coalescence_efficiency=ConstEc(Ec=0.0),
            breakup_efficiency=ConstEb(Eb=1.0),
            fragmentation_function=fragmentation_function,
            croupier=croupier,
            optimized_random=optimized_random,
            substeps=substeps,
            adaptive=adaptive,
            dt_coal_range=dt_coal_range,
            enable_breakup=True,
            warn_overflows=warn_overflows,
        )
