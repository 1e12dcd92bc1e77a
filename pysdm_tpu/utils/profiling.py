"""Structured profiling helpers (SURVEY.md §5: the reference has only
wall-clock timers — ``PySDM/impl/wall_timer.py`` — and no profiler
integration; on a JAX device the native tool is the jax profiler trace).

Two entry points:

- :func:`trace` — context manager wrapping ``jax.profiler.trace``; view the
  resulting trace in TensorBoard's profile plugin or Perfetto.
- :func:`profile_run` — runs ``particulator.run`` per dynamic (the opt-in
  per-dynamic dispatch mode) under named ``TraceAnnotation`` scopes so each
  dynamic's device time is attributable in the trace, and returns the
  host-side per-dynamic wall times as a dict (the programmatic counterpart
  of the ``DynamicWallTime`` product).
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir):
    """profile a ``with`` block into ``logdir`` (TensorBoard/Perfetto)"""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_run(particulator, n_steps, logdir=None):
    """run ``n_steps`` with per-dynamic dispatch under trace annotations;
    returns {dynamic_name: total_wall_seconds}. When ``logdir`` is given the
    run is additionally captured as a jax profiler trace."""
    ctx = trace(logdir) if logdir is not None else contextlib.nullcontext()
    times = {name: 0.0 for name, _ in particulator._named_step_fns}
    with ctx:
        sim = particulator.sim_state
        for _ in range(n_steps):
            for name, fn in particulator._named_step_fns:
                with jax.profiler.TraceAnnotation(name):
                    t0 = time.perf_counter()
                    sim = fn(sim)
                    jax.block_until_ready(sim)
                    times[name] += time.perf_counter() - t0
        particulator.sim_state = sim
        particulator.n_steps += n_steps
    return times
