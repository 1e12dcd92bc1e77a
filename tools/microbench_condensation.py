"""Time the two formulations of the condensation solve on the card: the
Pallas-Triton kernel (at each candidate block size) and the XLA
formulation. Decides whether the kernel stays and at which block size.

    python tools/microbench_condensation.py

Measures, in one process on one GPU, each as one JSON line:
- the per-drop solve alone on the 2.56M drops of the warm-rain state
  after a few steps (median of repeated calls, each ending in
  ``block_until_ready``), with ``sorted_segment_sum`` at the same size;
- end to end, ms/step of the parcel and warm-rain runs with the kernel
  off and on, in turns (xla, kernel, kernel, xla). The kernel is switched
  by replacing ``use_condensation_kernel`` in this process only.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

BLOCKS = (128, 256, 512)
NUM_WARPS = 4
REPS = 20


def median_ms(fn, *args, reps=REPS):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def solve_alone():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pysdm_tpu.ops.condensation import make_drop_solver
    from pysdm_tpu.ops.pallas.condensation import masses_new_kernel
    from pysdm_tpu.ops.segments import sorted_segment_sum

    f, args = chip_smoke.warm_rain_drop_inputs()
    masses_new = make_drop_solver(
        f, rtol_x=1e-6, RH_rtol=1e-7, max_iters=16, bisect_iters=64
    )
    out = {"n_drops": int(args[0].shape[0])}
    out["xla_solve_ms"] = median_ms(jax.jit(masses_new), *args)
    for block in BLOCKS:
        kernel = jax.jit(
            lambda *a, b=block: masses_new_kernel(
                masses_new, *a, block=b, num_warps=NUM_WARPS
            )
        )
        out[f"kernel_b{block}_w{NUM_WARPS}_ms"] = median_ms(kernel, *args)
    n = args[0].shape[0]
    n_cell = chip_smoke.WR_GRID[0] * chip_smoke.WR_GRID[1]
    cell_start = jnp.asarray(
        np.arange(n_cell + 1, dtype=np.int32) * (n // n_cell)
    )
    segsum = jax.jit(lambda v: sorted_segment_sum(v, cell_start, n_cell))
    out["sorted_segment_sum_ms"] = median_ms(segsum, args[0])
    chip_smoke.log(json.dumps(out))


def end_to_end():
    import bench
    import pysdm_tpu.ops.condensation as cond_ops

    default_choice = cond_ops.use_condensation_kernel
    for variant in ("xla", "kernel", "kernel", "xla"):
        if variant == "xla":
            cond_ops.use_condensation_kernel = lambda dtype: False
        else:
            cond_ops.use_condensation_kernel = default_choice
        out = {"variant": variant}
        out.update(bench.run_parcel())
        out.update(bench.run_warm_rain(n_steps=10))
        chip_smoke.log(json.dumps(out))
    cond_ops.use_condensation_kernel = default_choice


def main():
    chip_smoke.require_gpus(1)
    from pysdm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    solve_alone()
    end_to_end()


if __name__ == "__main__":
    main()
