"""Per-dynamic wall-time split of the 2D warm-rain step (one dispatch and
device sync per dynamic per step). Prints one JSON line of per-dynamic
ms/step.

    python tools/profile_warmrain.py [n_steps]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pysdm_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.models.arabas_et_al_2015 import Settings, make_simulation
    from pysdm_tpu.physics import Formulae, si

    settings = Settings(
        Formulae(seed=44),
        grid=(25, 25),
        size=(1500 * si.m, 1500 * si.m),
        n_sd_per_gridbox=2**12,
        spin_up_time=0,
    )
    particulator, spin_up = make_simulation(settings, backend_class=TPU)
    spin_up.finish()
    particulator.enable_per_dynamic_timing(True)
    t0 = time.perf_counter()
    particulator.run(1)  # per-dynamic compiles
    particulator.block_until_ready()
    print(json.dumps({"compile_and_first_step_s": round(
        time.perf_counter() - t0, 1)}), flush=True)
    particulator.timers.clear()
    particulator.run(n_steps)
    particulator.block_until_ready()
    out = {
        k: round(v / n_steps * 1e3, 1) for k, v in particulator.timers.items()
    }
    out["n_steps"] = n_steps
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
