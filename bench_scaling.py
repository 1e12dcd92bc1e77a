"""Weak-scaling harness for the distributed 2D warm-rain case
(BASELINE.json north star: >=90% weak scaling at >=2 hosts).

Holds the per-shard problem size constant — grid (8 x 16) columns and 32
SDs/gridbox per shard — and widens the domain with the shard count, so a
perfectly-scaling run keeps step time flat. Prints one JSON line per shard
count plus a summary line with the weak-scaling efficiency
t(1 shard)/t(N shards).

On several real GPUs this measures halo-exchange + particle-migration
overhead directly. On a single host it can be run
against the emulated CPU device mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``)
— there the emulated "devices" share physical cores, so the numbers
validate the harness and the sharded step's correctness, not hardware
scaling. Multi-host: launch one process per host with
``PYSDM_TPU_DIST_COORD/NPROC/PID`` set (see ``parallel/multihost.py``) and
the same script aggregates over the process-spanning mesh.

Usage: python bench_scaling.py [max_shards] [n_steps]
"""

import json
import sys
import time

import numpy as np


def run_case(n_shards, n_steps, nx_per_shard=8, nz=16, n_sd_per_gridbox=32):
    import jax

    from pysdm_tpu.models.arabas_et_al_2015 import Settings
    from pysdm_tpu.parallel import DistributedSimulation2D
    from pysdm_tpu.physics import Formulae, si

    nx = nx_per_shard * n_shards
    settings = Settings(
        Formulae(seed=44),
        grid=(nx, nz),
        size=(1500 * si.m * n_shards, 1500 * si.m),
        dt=5 * si.s,
        n_sd_per_gridbox=n_sd_per_gridbox,
        spin_up_time=0,
    )
    sim = DistributedSimulation2D(settings, n_shards=n_shards)
    sim.run(1)  # compile + warm up
    jax.block_until_ready(sim.particulator.sim_state)
    t0 = time.perf_counter()
    sim.run(n_steps)
    jax.block_until_ready(sim.particulator.sim_state)
    elapsed = time.perf_counter() - t0
    n_cell = nx * nz
    return {
        "n_shards": n_shards,
        "ms_per_step": float(f"{elapsed / n_steps * 1e3:.4g}"),
        "grid_points_per_s": float(f"{n_cell * n_steps / elapsed:.4g}"),
        "sd_per_shard": settings.n_sd // n_shards,
    }


def main():
    if "--cpu" in sys.argv:
        # the config call must land before any device op (run with
        # XLA_FLAGS=--xla_force_host_platform_device_count=8 for a mesh)
        sys.argv.remove("--cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    max_shards = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    results = []
    shards = [s for s in (1, 2, 4, 8, 16, 32) if s <= max_shards]
    for n in shards:
        r = run_case(n, n_steps)
        results.append(r)
        print(json.dumps(r), flush=True)

    if len(results) > 1:
        base = results[0]["ms_per_step"]
        print(
            json.dumps(
                {
                    "metric": "weak_scaling_efficiency",
                    "value": float(
                        f"{base / results[-1]['ms_per_step']:.4g}"
                    ),
                    "unit": f"t(1)/t({results[-1]['n_shards']})",
                    "per_shard": {
                        str(r["n_shards"]): r["ms_per_step"] for r in results
                    },
                }
            )
        )


if __name__ == "__main__":
    main()
