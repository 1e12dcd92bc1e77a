"""Benchmark: SDM throughput on the accelerator JAX finds.

Prints a consolidated JSON line (``{"metric", "value", "unit",
"vs_baseline", "extra"}``) after every config completes — flushed
immediately — so a timeout at any point still leaves every number measured
so far (the last line is always the most complete record). Every config
result names the device it ran on (``platform``, ``device_kind``,
``device_count``).

Configs, in headline-first order (per BASELINE.json), all float32 through
the ``TPU`` backend class:

1. ``box`` — 0D box, Golovin kernel, exponential spectrum, 2^20 SDs,
   100 steps (the reference's headline box case — scaled-up
   ``examples/PySDM_examples/Shima_et_al_2009/example.py:50-57``).
   Primary metric: super-droplet pair-updates/s.
2. ``parcel`` — adiabatic parcel activation, 2^17 SDs, 100 steps
   (BASELINE config #3): droplet-steps/s.
3. ``breakup`` — box + geometric kernel + collisional breakup, 2^17 SDs,
   100 steps (BASELINE config #2, ``deJong_Mackay_et_al_2023``).
4. ``warm_rain`` — 2D kinematic warm-rain (Arabas et al. 2015), 25x25
   grid, 2^12 SDs/gridbox = 2.56M SDs, full physics (reference
   ``examples/PySDM_examples/Arabas_et_al_2015/example_benchmark.py:26-66``).

Each ``run_*`` function checks its run (mass conserved, no failed
condensation cell, multiplicities >= 0, coalescence happened) and returns
ms/step with the device's peak memory; ``chip_smoke.py`` calls the same
functions for a few steps.

Each config runs in its own subprocess, one at a time, so one process holds
the card; the parent never imports JAX. A failed config is retried once
with the same command; if it still fails, the script exits non-zero after
printing what was measured. The whole run targets
``PYSDM_TPU_BENCH_BUDGET_S`` seconds (default 1650).

``vs_baseline`` divides by a stand-in for the reference's multithreaded
Numba CPU backend: ``tools/baseline_numpy_box.py`` re-implements the
reference box step (semantics of
``PySDM/backends/impl_numba/methods/collisions_methods.py:45-59,523-560``)
in vectorized NumPy, which measured 1.509e6 pair-updates/s single-threaded
on a 2-core host (2026-08-21); the denominator scales that by an assumed
8x multithreaded-Numba speedup -> 1.2e7.
"""

import json
import os
import subprocess
import sys
import time

REFERENCE_PAIR_UPDATES_PER_S = 1.2e7

BOX_N_SD = 2**20
BOX_N_STEPS = 100
PARCEL_N_SD = 2**17
BREAKUP_N_SD = 2**17
SMALL_N_STEPS = 100
WR_GRID = (25, 25)
WR_N_SD_PER_GRIDBOX = 2**12
WR_N_STEPS = 30


def device_info():
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def peak_bytes_in_use():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _timed_run(particulator, n_steps):
    """compile + warm up on one step, then time ``n_steps`` (one dispatch:
    ``run(n)`` jits a fori_loop whose trip count is a traced argument)"""
    particulator.run(1)
    particulator.block_until_ready()
    t0 = time.perf_counter()
    particulator.run(n_steps)
    particulator.block_until_ready()
    return (time.perf_counter() - t0) / n_steps


def _liquid_mass(particulator):
    import numpy as np

    mult = np.asarray(particulator.attributes["multiplicity"], np.float64)
    return float((mult * particulator.attributes["water mass"]).sum())


def _check_multiplicities(particulator):
    import numpy as np

    mult = np.asarray(particulator.attributes["multiplicity"])
    assert (mult >= 0).all(), "negative multiplicity"
    return float(mult.astype(np.float64).sum())


def _check_condensation(particulator):
    import numpy as np

    success = np.asarray(particulator.get_counter("condensation_success"))
    assert success.all(), f"{int((~success).sum())} failed condensation cells"


def build_box(n_sd):
    from pysdm_tpu import Builder, Formulae
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.dynamics import Coalescence
    from pysdm_tpu.dynamics.collisions.collision_kernels import Golovin
    from pysdm_tpu.environments import Box
    from pysdm_tpu.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu.initialisation.spectra import Exponential
    from pysdm_tpu.physics import si

    formulae = Formulae(seed=44)
    env = Box(dv=1e6 * si.m**3, dt=1.0 * si.s)
    builder = Builder(n_sd=n_sd, backend=TPU(formulae), environment=env)
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    spectrum = Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=False)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def run_box(n_sd=BOX_N_SD, n_steps=BOX_N_STEPS):
    particulator = build_box(n_sd)
    mass0 = _liquid_mass(particulator)
    count0 = _check_multiplicities(particulator)
    t_step = _timed_run(particulator, n_steps)
    count1 = _check_multiplicities(particulator)
    mass1 = _liquid_mass(particulator)
    assert abs(mass1 - mass0) <= 1e-6 * mass0, (mass0, mass1)
    assert count1 < count0, "no coalescence happened"
    return {
        "box_pair_updates_per_s": n_sd / 2 / t_step,
        "box_ms_per_step": t_step * 1e3,
        "box_peak_bytes_in_use": peak_bytes_in_use(),
    }


def build_parcel(n_sd):
    from pysdm_tpu import Builder, Formulae
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.dynamics import AmbientThermodynamics, Condensation
    from pysdm_tpu.environments import Parcel
    from pysdm_tpu.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu.initialisation.spectra import Lognormal

    formulae = Formulae(seed=44)
    env = Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=0.0158, T0=300.0, w=2.0,
    )
    builder = Builder(n_sd=n_sd, backend=TPU(formulae), environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=True))
    spectrum = Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = ConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes)


def run_parcel(n_sd=PARCEL_N_SD, n_steps=SMALL_N_STEPS):
    """BASELINE config #3: adiabatic parcel activation (reference
    ``examples/PySDM_examples/Abdul_Razzak_Ghan_2000`` / ``Pyrcel``)"""
    particulator = build_parcel(n_sd)
    t_step = _timed_run(particulator, n_steps)
    _check_condensation(particulator)
    _check_multiplicities(particulator)
    return {
        "parcel_droplet_steps_per_s": n_sd / t_step,
        "parcel_ms_per_step": t_step * 1e3,
        "parcel_peak_bytes_in_use": peak_bytes_in_use(),
    }


def build_breakup(n_sd):
    from pysdm_tpu import Builder
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.dynamics import Collision
    from pysdm_tpu.environments import Box
    from pysdm_tpu.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu.models.dejong_mackay_et_al_2023 import Settings0D

    s = Settings0D(seed=44, warn_overflows=False)
    s.n_sd = n_sd
    env = Box(dv=s.dv, dt=s.dt)
    builder = Builder(n_sd=n_sd, backend=TPU(s.formulae), environment=env)
    builder.add_dynamic(
        Collision(
            collision_kernel=s.kernel,
            coalescence_efficiency=s.coal_eff,
            breakup_efficiency=s.break_eff,
            fragmentation_function=s.fragmentation,
            adaptive=s.adaptive,
            warn_overflows=False,
        )
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def run_breakup(n_sd=BREAKUP_N_SD, n_steps=SMALL_N_STEPS):
    """BASELINE config #2: box, geometric kernel + collisional breakup
    (reference ``examples/PySDM_examples/deJong_Mackay_et_al_2023``)"""
    import numpy as np

    particulator = build_breakup(n_sd)
    mass0 = _liquid_mass(particulator)
    t_step = _timed_run(particulator, n_steps)
    _check_multiplicities(particulator)
    mass1 = _liquid_mass(particulator)
    assert abs(mass1 - mass0) <= 1e-5 * mass0, (mass0, mass1)
    assert np.asarray(particulator.get_counter("collision_rate")).sum() > 0
    substeps = np.asarray(particulator.get_counter("collision_n_substep"))
    return {
        "breakup_pair_updates_per_s": n_sd / 2 / t_step,
        "breakup_ms_per_step": t_step * 1e3,
        "breakup_substeps_per_step": float(substeps.sum()) / (n_steps + 1),
        "breakup_peak_bytes_in_use": peak_bytes_in_use(),
    }


def build_warm_rain(grid=WR_GRID, n_sd_per_gridbox=WR_N_SD_PER_GRIDBOX):
    """the full-physics 2D kinematic case, collisions and sedimentation on
    from the first step; returns (particulator, settings)"""
    from pysdm_tpu.backends import TPU
    from pysdm_tpu.models.arabas_et_al_2015 import Settings, make_simulation
    from pysdm_tpu.physics import Formulae, si

    settings = Settings(
        Formulae(seed=44),
        grid=grid,
        size=(1500 * si.m, 1500 * si.m),
        n_sd_per_gridbox=n_sd_per_gridbox,
        spin_up_time=0,
    )
    particulator, spin_up = make_simulation(settings, backend_class=TPU)
    spin_up.finish()
    return particulator, settings


def run_warm_rain(
    grid=WR_GRID, n_sd_per_gridbox=WR_N_SD_PER_GRIDBOX, n_steps=WR_N_STEPS
):
    import numpy as np

    particulator, settings = build_warm_rain(grid, n_sd_per_gridbox)
    t_step = _timed_run(particulator, n_steps)
    _check_condensation(particulator)
    _check_multiplicities(particulator)
    assert np.asarray(particulator.get_counter("coalescence_rate")).sum() > 0
    for field in ("thd", "qv"):
        assert np.isfinite(particulator.get_env(field)).all(), field
    n_cell = grid[0] * grid[1]
    return {
        "warm_rain_grid_points_per_s": n_cell / t_step,
        "warm_rain_pair_updates_per_s": settings.n_sd / 2 / t_step,
        "warm_rain_ms_per_step": t_step * 1e3,
        "warm_rain_grid": f"{grid[0]}x{grid[1]}",
        "warm_rain_n_sd": settings.n_sd,
        "warm_rain_peak_bytes_in_use": peak_bytes_in_use(),
    }


CONFIGS = {
    "box": run_box,
    "parcel": run_parcel,
    "breakup": run_breakup,
    "warm_rain": run_warm_rain,
}


def child(config):
    from pysdm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = device_info()
    out.update(CONFIGS[config]())
    print(json.dumps(out))


def _run_child(config, timeout_s):
    """run `python bench.py --child CONFIG`; returns (json|None, error)"""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", config],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            check=False,
        )
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout_s:.0f}s"
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    if proc.returncode == 0 and lines:
        try:
            return json.loads(lines[-1]), ""
        except json.JSONDecodeError as exc:
            return None, f"bad JSON: {exc}"
    tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-6:]
    return None, f"rc={proc.returncode}: " + " | ".join(tail)[-500:]


# nominal per-attempt timeouts (cold compile included)
_TIMEOUT_S = {"box": 900, "parcel": 900, "breakup": 900, "warm_rain": 1800}
_ATTEMPTS = 2


def _attempt(config, deadline):
    errors = []
    for i in range(_ATTEMPTS):
        remaining = deadline - time.monotonic()
        if remaining < 60:
            errors.append(f"attempt {i}: skipped (budget exhausted)")
            break
        result, err = _run_child(config, min(_TIMEOUT_S[config], remaining))
        if result is not None:
            if errors:
                result["prior_errors"] = errors
            return result
        errors.append(f"attempt {i}: {err}")
    return {"error": "; ".join(errors)[-800:]}


def _consolidated(results):
    """merge per-config results into one record"""
    extra = {}
    for name, result in results.items():
        for key, value in result.items():
            prefixed = not key.startswith(name + "_")
            extra[f"{name}_{key}" if prefixed else key] = value
    rate = results.get("box", {}).get("box_pair_updates_per_s", 0.0)
    return {
        "metric": "sd_pair_updates_per_s",
        "value": rate,
        "unit": "pair-updates/s",
        "vs_baseline": rate / REFERENCE_PAIR_UPDATES_PER_S,
        "extra": extra,
    }


def main():
    budget = float(os.environ.get("PYSDM_TPU_BENCH_BUDGET_S", 1650))
    deadline = time.monotonic() + budget
    results = {}
    for config in CONFIGS:
        results[config] = _attempt(config, deadline)
        print(json.dumps(_consolidated(results)), flush=True)
    if any("error" in result for result in results.values()):
        sys.exit(1)


if __name__ == "__main__":
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1])
    else:
        main()
