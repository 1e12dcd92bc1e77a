"""Roofline accounting for the box-coalescence step: times the full fused
step and, for comparison, the bucket-shuffle sort that the sort-free
mirror croupier (``ops/pairing.py``) avoids (K data-dependent steps in one
dispatch), and reports bytes touched against the card's HBM bound
(``tools/device_peaks.py``).

    python tools/roofline_box.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pysdm_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

K = 30
N_SD = 2**20


def chained_ms(fn, state, k=K):
    """time k data-dependent invocations in ONE dispatch; the completion
    barrier fetches one device-reduced scalar"""
    @jax.jit
    def run(s):
        out = jax.lax.fori_loop(jnp.int32(0), jnp.int32(k), fn, s)
        sink = jnp.zeros((), jnp.float32)
        for leaf in jax.tree_util.tree_leaves(out):
            sink = sink + jnp.sum(leaf).astype(jnp.float32)
        return out, sink

    _, sink = run(state)
    float(sink)  # warm + completion barrier
    t0 = time.perf_counter()
    _, sink = run(state)
    float(sink)
    return (time.perf_counter() - t0) / k * 1e3


def main():
    import bench
    from device_peaks import hbm_bytes_per_s

    hbm = hbm_bytes_per_s(jax.devices()[0].device_kind)
    particulator = bench.build_box(N_SD)
    particulator.run(1)
    particulator.block_until_ready()
    sim0 = particulator.sim_state

    # full step
    step = particulator._step_fn_raw

    def full(i, sim):
        return step(sim)

    full_ms = chained_ms(full, sim0)

    # sort phase only: bucket shuffle with a fresh fold of the key
    from pysdm_tpu.ops.segments import bucket_shuffle_state

    n_cell = particulator.mesh.n_cell
    mesh = particulator.mesh

    def sort_only(i, sim):
        p = sim["particles"]
        key = jax.random.fold_in(sim["key"], i)
        rand = jax.random.bits(key, (p.n_sd,), jnp.uint32)
        p2, _, _, _ = bucket_shuffle_state(p, rand, n_cell, mesh)
        return {**sim, "particles": p2}

    sort_ms = chained_ms(sort_only, sim0)

    # bytes accounting (per step): one pass over the u32 key + state rows
    p = sim0["particles"]
    payload_bytes = sum(
        np.asarray(a).dtype.itemsize * N_SD
        for a in ([p.multiplicity] + list(p.extensive) + list(p.maximum)
                  + list(p.position_in_cell))
    )
    key_bytes = 4 * N_SD
    one_pass = payload_bytes + key_bytes

    one_pass_ms = one_pass / hbm * 1e3
    out = {
        "device_kind": jax.devices()[0].device_kind,
        "full_step_ms": full_ms,
        "sort_ms": sort_ms,
        "state_bytes_per_pass_MB": one_pass / 2**20,
        "hbm_bound_single_pass_ms": one_pass_ms,
        "implied_sort_passes_at_hbm_bound": sort_ms / one_pass_ms,
        "implied_step_passes_at_hbm_bound": full_ms / one_pass_ms,
        "pair_updates_per_s": N_SD / 2 / (full_ms / 1e3),
        "n_sd": N_SD,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
