"""Particulator: simulation driver and mediator
(API parity: reference ``PySDM/particulator.py``).

Design: the per-step work of all registered dynamics is composed
into a single pure function over the simulation-state pytree and compiled once
with ``jax.jit``; ``run(steps)`` replays it. Products and attribute accessors
pull device data on demand (the only host<->device transfers).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from .impl.attributes import AttributeResolver
from .ops import moments as moments_ops


class _AttributeView:
    """dict-like read access to (possibly derived) attributes as numpy arrays"""

    def __init__(self, particulator):
        self._p = particulator

    def __getitem__(self, name):
        return np.asarray(self._p.get_attribute(name))

    def __contains__(self, name):
        try:
            self._p.get_attribute(name)
        except (KeyError, AttributeError, TypeError):
            return False
        return True


class Particulator:
    def __init__(self, n_sd, backend):
        self.n_sd = n_sd
        self.backend = backend
        self.formulae = backend.formulae
        self.dtype = backend.dtype
        self.mult_dtype = backend.mult_dtype
        self.environment = None
        self.mesh = None
        self.dt = None
        self.dynamics = {}
        self.products = {}
        self.observers = []
        self.n_steps = 0
        self.sim_state = None  # {'particles', 'env', 'counters', 'key'}
        self._step_fn = None
        self._resolver = AttributeResolver(self.formulae)
        self.attributes = _AttributeView(self)
        self.timers = {}
        self.u01_injection = False

    # -- stepping -------------------------------------------------------
    def run(self, steps):
        """advance `steps` time steps. Without observers the whole chunk runs
        as ONE device dispatch (jitted fori_loop over the composed step);
        with observers, steps run one dispatch each with host callbacks in
        between (reference semantics: observers notified every step,
        reference ``particulator.py:58-61``)."""
        t0 = time.perf_counter()
        if getattr(self, "per_dynamic_timing", False):
            for _ in range(steps):
                sim = self.sim_state
                for name, fn in self._named_step_fns:
                    t_dyn = time.perf_counter()
                    sim = fn(sim)
                    jax.block_until_ready(sim)
                    self.timers[name] = self.timers.get(name, 0.0) + (
                        time.perf_counter() - t_dyn
                    )
                self.sim_state = sim
                self.n_steps += 1
                for observer in self.observers:
                    observer.notify()
        elif self.observers:
            for _ in range(steps):
                self.sim_state = self._step_fn(self.sim_state)
                self.n_steps += 1
                for observer in self.observers:
                    observer.notify()
        elif steps > 0:
            self.sim_state = self._multi_step_fn(
                self.sim_state, jnp.asarray(steps, dtype=jnp.int32)
            )
            self.n_steps += steps
        self.timers["total"] = self.timers.get("total", 0.0) + (
            time.perf_counter() - t0
        )

    def block_until_ready(self):
        jax.block_until_ready(self.sim_state)

    def enable_per_dynamic_timing(self, enable=True):
        """opt into per-dynamic dispatch (one jit + device sync per dynamic
        per step) so ``DynamicWallTime`` reports real per-dynamic wall times
        (reference ``impl/wall_timer.py:9-22``). Costs one dispatch latency
        per dynamic per step — a profiling mode, not the production path."""
        self.per_dynamic_timing = enable

    # -- state access ---------------------------------------------------
    @property
    def particles(self):
        return self.sim_state["particles"]

    def get_attribute(self, name):
        return self._resolver.get(
            self.sim_state["particles"], name, env=self.sim_state["env"]
        )

    def get_counter(self, name):
        return np.asarray(self.sim_state["counters"][name])

    def reset_counter(self, name):
        c = self.sim_state["counters"][name]
        self.sim_state["counters"][name] = jnp.zeros_like(c)

    def set_flag(self, name, value):
        if name not in self.sim_state["flags"]:
            raise KeyError(f"unknown flag: {name}")
        self.sim_state["flags"][name] = jnp.asarray(bool(value))

    def inject_u01(self, streams: dict):
        """parity/validation mode: replace injected u01 arrays (one per
        purpose, shape (n_sd,)) consumed by the NEXT step. Requires the
        simulation to have been built after Builder.enable_u01_injection."""
        if not self.u01_injection:
            raise RuntimeError(
                "u01 injection not enabled (Builder.enable_u01_injection)"
            )
        for name, arr in streams.items():
            if name not in self.sim_state["u01"]:
                raise KeyError(f"unknown u01 purpose: {name}")
            self.sim_state["u01"][name] = jnp.asarray(arr, dtype=self.dtype)

    def get_env(self, key):
        if key in self.sim_state["env"]:
            return np.asarray(self.sim_state["env"][key])
        return np.asarray(self.environment[key])

    # -- reductions for products ----------------------------------------
    def moments(
        self,
        *,
        attr_name,
        ranks,
        filter_attr="volume",
        filter_range=(-np.inf, np.inf),
        weighting_attribute=None,
        weighting_rank=0,
        skip_division_by_m0=False,
    ):
        particles = self.sim_state["particles"]
        env = self.sim_state["env"]
        attr = self._resolver.get(particles, attr_name, env=env)
        filt = self._resolver.get(particles, filter_attr, env=env)
        weight = (
            self._resolver.get(particles, weighting_attribute, env=env)
            if weighting_attribute
            else None
        )
        m0, mk = moments_ops.moments(
            multiplicity=particles.multiplicity,
            attr_data=attr,
            cell_id=particles.cell_id,
            ranks=tuple(ranks),
            filter_attr_data=filt,
            min_x=filter_range[0],
            max_x=filter_range[1],
            n_cell=self.mesh.n_cell,
            weighting_attribute=weight,
            weighting_rank=weighting_rank,
            skip_division_by_m0=skip_division_by_m0,
        )
        return np.asarray(m0), np.asarray(mk)

    def spectrum_moments(
        self,
        *,
        attr_name,
        rank,
        attr_bins,
        filter_attr=None,
        weighting_attribute=None,
        weighting_rank=0,
    ):
        particles = self.sim_state["particles"]
        env = self.sim_state["env"]
        attr = self._resolver.get(particles, attr_name, env=env)
        x_attr = (
            self._resolver.get(particles, filter_attr, env=env)
            if filter_attr
            else attr
        )
        weight = (
            self._resolver.get(particles, weighting_attribute, env=env)
            if weighting_attribute
            else None
        )
        m0, mk = moments_ops.spectrum_moments(
            multiplicity=particles.multiplicity,
            attr_data=attr,
            x_attr=x_attr,
            cell_id=particles.cell_id,
            x_bins=jnp.asarray(attr_bins, dtype=self.dtype),
            rank=rank,
            n_cell=self.mesh.n_cell,
            weighting_attribute=weight,
            weighting_rank=weighting_rank,
        )
        return np.asarray(m0), np.asarray(mk)
