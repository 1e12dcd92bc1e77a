"""Per-phase roofline of the 2D warm-rain step: chained-dispatch timing of
each dynamic plus the sub-phases the per-dynamic split can't see — the two
full-state sorts (condensation's stable cell sort, collision's bucket
shuffle) — with post-fusion bytes accessed per phase from the compiled
cost_analysis, against the card's HBM bound (``tools/device_peaks.py``).
Prints one JSON line.

    python tools/roofline_warmrain.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from pysdm_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def chained_ms(fn, state, k=6):
    @jax.jit
    def run(s):
        out = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(k), lambda i, x: fn(x), s
        )
        sink = jnp.zeros((), jnp.float32)
        for leaf in jax.tree_util.tree_leaves(out):
            sink = sink + jnp.sum(leaf).astype(jnp.float32)
        return out, sink

    _, sink = run(state)
    float(sink)
    t0 = time.perf_counter()
    _, sink = run(state)
    float(sink)
    return (time.perf_counter() - t0) / k * 1e3


def phase_bytes(fn, state):
    try:
        ca = jax.jit(fn).lower(state).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return round(ca.get("bytes accessed", 0.0) / 2**20)
    except Exception:
        return None


def main():
    from device_peaks import hbm_bytes_per_s
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.models.arabas_et_al_2015 import Settings, make_simulation
    from pysdm_tpu.physics import Formulae, si

    hbm = hbm_bytes_per_s(jax.devices()[0].device_kind)
    settings = Settings(
        Formulae(seed=44),
        grid=(25, 25),
        size=(1500 * si.m, 1500 * si.m),
        n_sd_per_gridbox=2**12,
        spin_up_time=0,
    )
    t0 = time.perf_counter()
    particulator, spin_up = make_simulation(settings, backend_class=TPU)
    spin_up.finish()
    particulator.run(1)
    particulator.block_until_ready()
    out = {
        "device_kind": jax.devices()[0].device_kind,
        "build_compile_first_step_s": time.perf_counter() - t0,
    }

    sim0 = particulator.sim_state
    mesh = particulator.mesh
    n_cell = mesh.n_cell

    # full fused step
    out["full_step_ms"] = chained_ms(particulator._step_fn_raw, sim0)
    out["full_step_MB"] = phase_bytes(particulator._step_fn_raw, sim0)

    # per-dynamic phases (chained within one dispatch each — unlike the
    # per-dynamic timing mode this pays dispatch latency once per phase)
    for name, _jitted in particulator._named_step_fns:
        raw = None
        for nm, fn in particulator._named_step_fns_raw:
            if nm == name:
                raw = fn
        if raw is None:
            continue
        out[f"{name}_ms"] = chained_ms(raw, sim0)
        out[f"{name}_MB"] = phase_bytes(raw, sim0)

    # sub-phases: the two sorts at flagship scale
    from pysdm_tpu.ops.segments import bucket_shuffle_state, sort_state_by_cell

    def stable_sort_only(sim):
        p, _, _ = sort_state_by_cell(sim["particles"], n_cell, mesh)
        return {**sim, "particles": p}

    def shuffle_sort_only(sim):
        key = jax.random.fold_in(sim["key"], 1)
        rand = jax.random.bits(key, (sim["particles"].n_sd,), jnp.uint32)
        p, _, _, _ = bucket_shuffle_state(sim["particles"], rand, n_cell, mesh)
        return {**sim, "particles": p, "key": key}

    out["stable_cell_sort_ms"] = chained_ms(stable_sort_only, sim0)
    out["bucket_shuffle_ms"] = chained_ms(shuffle_sort_only, sim0)

    p = sim0["particles"]
    state_mb = sum(
        a.dtype.itemsize * a.size
        for a in [p.multiplicity] + list(p.extensive) + list(p.maximum)
        + list(p.position_in_cell)
    ) / 2**20
    out["state_MB_per_pass"] = state_mb
    out["hbm_single_pass_ms"] = state_mb * 2**20 / hbm * 1e3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
