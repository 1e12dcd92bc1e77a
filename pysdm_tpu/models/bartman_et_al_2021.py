"""Bartman et al. 2021 (JOSS 6) performance-benchmark harness (reference
``examples/PySDM_examples/Bartman_et_al_2021/demo_fig2.ipynb`` +
``Arabas_et_al_2015/example_benchmark.py:26-66``): wall time of the 2D
kinematic warm-rain case vs n_sd per gridbox, on the available backend(s).
The reference sweeps CPU-sync/CPU-async/GPU; here the sweep is over
backend classes (CPU = the float64 JaxBackend, TPU = its float32
subclass) and SD counts."""

import time

from ..backends import CPU
from ..physics import Formulae, si
from .arabas_et_al_2015 import Settings, make_simulation


def benchmark(
    *,
    backend_classes=(CPU,),
    n_sd_per_gridbox_list=(2**5, 2**7),
    grid=(25, 25),
    n_steps=100,
    dt=5 * si.s,
    seed=44,
):
    """returns {backend_name: {n_sd_per_gridbox: seconds}} — wall time of
    ``n_steps`` full physics steps (after spin-up-free warm-up/compile)"""
    results = {}
    for backend_class in backend_classes:
        times = {}
        for n_sd_per_gridbox in n_sd_per_gridbox_list:
            settings = Settings(
                Formulae(seed=seed),
                grid=grid,
                n_sd_per_gridbox=n_sd_per_gridbox,
                dt=dt,
                spin_up_time=0,
            )
            particulator, spin_up = make_simulation(
                settings, backend_class=backend_class
            )
            spin_up.finish()
            particulator.run(1)  # compile + warm-up
            particulator.block_until_ready()
            t0 = time.perf_counter()
            particulator.run(n_steps)
            particulator.block_until_ready()
            times[n_sd_per_gridbox] = time.perf_counter() - t0
        # CPU is an alias of JaxBackend while TPU subclasses it — label the
        # sweep rows so CPU and TPU results don't collide in the dict
        name = "CPU" if backend_class.__name__ == "JaxBackend" else (
            backend_class.__name__
        )
        results[name] = times
    return results
