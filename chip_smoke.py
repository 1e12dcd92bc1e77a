"""Smoke run of the engine on an NVIDIA GPU: the quickest proof that the
main path still compiles, runs and gives right answers on the card.

    python chip_smoke.py               # one card: phases 1-3
    python chip_smoke.py --four-gpus   # four cards: the decomposed 2D case

One card, one process, float32 main path (the ``TPU`` backend class):

1. kernel vs reference — the Pallas-Triton condensation kernel against the
   XLA formulation of the same per-drop solve, on the 2.56M drops of the
   warm-rain state after a few full-physics steps;
2. parity — the committed traces (``tests/data/parity_traces.json``)
   replayed in float64 through the code the CPU tests use;
3. main path — a few steps of each ``bench.py`` config at its full size,
   with that config's checks (mass conserved, no failed condensation cell,
   multiplicities >= 0, coalescence happened), printing ms/step and the
   device's peak memory.

``--four-gpus`` runs only the ``DistributedSimulation2D`` path: the
shard-invariance checks on mesh shapes (4, 1) and (2, 2) against the
one-device truth, then 2 full-physics steps on a 100x25 grid at 2^12
SDs per gridbox in 25x25 x-slabs, asserting that every shard lives on its
own card.

No phase falls back to the CPU and no failure is caught: the script exits
non-zero, without its last line, when JAX finds no GPU or any check fails.
The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

WR_GRID = (25, 25)
WR_N_SD_PER_GRIDBOX = 2**12
KERNEL_PHASE_STEPS = 3
MAIN_PATH_STEPS = {"box": 5, "parcel": 5, "breakup": 5, "warm_rain": 3}

# phase 1: both formulations stop bisecting once the bracket is narrower
# than rtol_x * |x_old| (the kernel per block, XLA over all drops), so on
# identical arithmetic their roots agree to 4 * rtol_x * |x_old| in the solve
# coordinate. In float32 they do not share arithmetic (Triton and XLA
# implement the transcendentals differently), and the float32 solve of a
# drop near saturation is ill-conditioned: measured against the float64
# solve of the same inputs, the float32 XLA formulation itself is off by up
# to ~40x that bound on a few hundred of the 2.56M drops. So the referee is
# the float64 solve, and the kernel must be no less accurate than the
# float32 XLA formulation, per drop (worst case) and per cell (liquid
# water), each within one more 4 * rtol_x * |x_old|; the success flags must
# be identical.
KERNEL_RTOL_X = 1e-6
KERNEL_TOL_FACTOR = 4

# phase 2: the parcel trace solves to rtol_x = 1e-6 in the log-mass
# coordinate, |x| ~ 30, so a bisection step decided the other way by a
# last-bit difference of the card's transcendentals moves a root by up to
# ~3e-5 relative in mass, ~1e-5 in radius; the cell state integrates
# multiplicity-weighted sums of such roots against ~1e-2 kg/kg of vapour.
PARCEL_RTOL_RADII = 1e-4
PARCEL_RTOL_STATE = 1e-7


def log(*args):
    print(*args, flush=True)


def require_gpus(count):
    """fail unless JAX's default backend is a GPU with >= count devices;
    prints the card as nvidia-smi and JAX name it"""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devices}")
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {devices}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log("jax devices:", [(str(d), d.device_kind) for d in devices])
    return devices


def drop_inputs(particulator):
    """the per-drop inputs of the condensation solve (``DROP_INPUTS``
    order) from a particulator's current state, as its next substep would
    see them at one substep per step"""
    import jax.numpy as jnp

    p = particulator.particles
    env = particulator.sim_state["env"]
    resolver = particulator._resolver
    n_cell = particulator.mesh.n_cell
    cell = jnp.clip(p.cell_id, 0, n_cell - 1)
    n_sub = particulator.sim_state["counters"]["condensation_n_substeps"]
    dt_sub = particulator.dt / n_sub.astype(env["thd"].dtype)
    return (
        p.ext("signed water mass"),
        p.ext("dry volume"),
        resolver.get(p, "kappa"),
        resolver.get(p, "dry volume organic fraction"),
        resolver.get(p, "Reynolds number", env=env),
        env["thd"][cell],
        env["qv"][cell],
        env["rhod"][cell],
        dt_sub[cell],
        (p.multiplicity > 0).astype(env["thd"].dtype),
        env["air_density"][cell],
        env["air_viscosity"][cell],
    )


def warm_rain_drop_inputs(grid=WR_GRID, n_sd_per_gridbox=WR_N_SD_PER_GRIDBOX,
                          n_steps=KERNEL_PHASE_STEPS):
    """build the full-size warm-rain case, compile its step (printing the
    compiled memory analysis), run ``n_steps`` and return (formulae, the
    per-drop condensation inputs, multiplicities, cell ids)"""
    import bench

    particulator, _ = bench.build_warm_rain(grid, n_sd_per_gridbox)
    t0 = time.perf_counter()
    step = particulator._step_fn.lower(particulator.sim_state).compile()
    log(f"warm-rain step compiled in {time.perf_counter() - t0:.1f} s;",
        step.memory_analysis())
    for _ in range(n_steps):
        particulator.sim_state = step(particulator.sim_state)
    p = particulator.particles
    return (
        particulator.formulae, drop_inputs(particulator),
        np.asarray(p.multiplicity, np.float64), np.asarray(p.cell_id),
    )


def phase_kernel(grid=WR_GRID, n_sd_per_gridbox=WR_N_SD_PER_GRIDBOX,
                 n_steps=KERNEL_PHASE_STEPS, interpret=False):
    """phase 1; returns the largest root difference in units of the
    tolerance"""
    import jax

    from pysdm_tpu.ops.condensation import make_drop_solver
    from pysdm_tpu.ops.pallas.condensation import masses_new_kernel

    f, args, mult, cell = warm_rain_drop_inputs(grid, n_sd_per_gridbox, n_steps)
    masses_new = make_drop_solver(
        f, rtol_x=KERNEL_RTOL_X, RH_rtol=1e-7, max_iters=16, bisect_iters=64
    )
    xla = jax.jit(masses_new)
    kernel = jax.jit(
        lambda *a: masses_new_kernel(masses_new, *a, interpret=interpret)
    )
    mass_x, ok_x = jax.block_until_ready(xla(*args))
    mass_k, ok_k = jax.block_until_ready(kernel(*args))
    mass_64, _ = xla(*(a.astype(np.float64) for a in args))
    assert mass_k.dtype == mass_x.dtype == np.float32, (mass_k.dtype,)
    ok_x, ok_k = np.asarray(ok_x), np.asarray(ok_k)
    assert np.array_equal(ok_x, ok_k), f"{int((ok_x != ok_k).sum())} flags differ"
    assert ok_x.all(), f"{int((~ok_x).sum())} drops failed"

    x = lambda m: np.asarray(  # noqa: E731
        f.diffusion_coordinate.x(np.asarray(m, np.float64)), np.float64
    )
    x_old = x(np.maximum(np.asarray(args[0]), 1e-18))
    tol = KERNEL_TOL_FACTOR * KERNEL_RTOL_X * np.abs(x_old)
    x_64 = x(mass_64)
    err = {
        name: np.abs(x(m) - x_64) / tol
        for name, m in (("kernel", mass_k), ("xla", mass_x))
    }
    n_cell = int(cell.max()) + 1
    ml = {
        name: np.bincount(cell, mult * np.asarray(m, np.float64), n_cell)
        for name, m in (("kernel", mass_k), ("xla", mass_x), ("f64", mass_64))
    }
    wet = ml["f64"] > 0
    cell_err = {
        name: float(np.max(np.abs(ml[name] - ml["f64"])[wet] / ml["f64"][wet]))
        for name in ("kernel", "xla")
    }
    cell_tol = float(KERNEL_TOL_FACTOR * KERNEL_RTOL_X * np.max(np.abs(x_old)))
    log(f"phase 1 kernel vs XLA vs float64 solve: {mass_k.shape[0]} drops; "
        "drops beyond 4 rtol_x of the f64 root: "
        f"kernel {int((err['kernel'] > 1).sum())}, "
        f"xla {int((err['xla'] > 1).sum())}; worst |dx| / (4 rtol_x |x_old|): "
        f"kernel {err['kernel'].max():.6g}, xla {err['xla'].max():.6g}; "
        f"worst per-cell liquid water rel. error: {cell_err}")
    assert err["kernel"].max() <= err["xla"].max() + 1
    assert cell_err["kernel"] <= cell_err["xla"] + cell_tol
    ratio = float(err["kernel"].max() / (err["xla"].max() + 1))
    assert ratio <= 1.0
    return ratio


def phase_parity():
    """phase 2: replay the committed f64 traces"""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_parity_traces import run_box_ours, run_parcel_ours

    with open(os.path.join(ROOT, "tests", "data", "parity_traces.json")) as fh:
        traces = json.load(fh)
    box = traces["box"]
    for got, exp in zip(run_box_ours(dict(box["case"])), box["expected"]):
        assert got["multiplicity"] == exp["multiplicity"]
    parcel = traces["parcel"]
    worst = {"radii": 0.0, "state": 0.0}
    for got, exp in zip(run_parcel_ours(dict(parcel["case"])), parcel["expected"]):
        for key in ("thd", "qv", "RH"):
            np.testing.assert_allclose(got[key], exp[key], rtol=PARCEL_RTOL_STATE)
            worst["state"] = max(worst["state"], abs(got[key] / exp[key] - 1))
        np.testing.assert_allclose(
            got["radii_um"], exp["radii_um"], rtol=PARCEL_RTOL_RADII
        )
        worst["radii"] = max(worst["radii"], float(np.max(np.abs(
            np.asarray(got["radii_um"]) / np.asarray(exp["radii_um"]) - 1
        ))))
    log(f"phase 2 parity: box multiplicities exact; parcel max rel diff {worst}")
    return worst


def phase_main_path(steps=MAIN_PATH_STEPS, sizes=None):
    """phase 3: a few steps of every bench config at its size"""
    import bench

    sizes = sizes or {}
    results = {}
    for name, run in bench.CONFIGS.items():
        t0 = time.perf_counter()
        out = run(n_steps=steps[name], **sizes.get(name, {}))
        out["wall_s_with_compile"] = time.perf_counter() - t0
        log(f"phase 3 {name}:", json.dumps(out))
        results[name] = out
    return results


def phase_four_gpus(n_devices=4, big_grid=(100, 25), n_sd_per_gridbox=2**12,
                    invariance_grid=(32, 16), invariance_sd=8):
    """the DistributedSimulation2D path on n_devices cards"""
    import jax

    from pysdm_tpu.backends import TPU
    from pysdm_tpu.models.arabas_et_al_2015 import Settings
    from pysdm_tpu.parallel import DistributedSimulation2D
    from pysdm_tpu.parallel.verification import (
        _global_field, canonical_particles,
    )
    from pysdm_tpu.physics import Formulae, si

    def invariance_settings():
        s = Settings(
            Formulae(seed=44),
            grid=invariance_grid,
            size=(1500 * si.m, 1500 * si.m),
            n_sd_per_gridbox=invariance_sd,
        )
        # pinned substep count: adaptivity is knife-edged between n and 2n
        s.condensation_adaptive = False
        return s

    def check_placement(sim, count):
        devices = sim.jmesh.devices.ravel()
        assert len({d.id for d in devices}) == count, devices
        for leaf in jax.tree_util.tree_leaves(sim.particulator.sim_state["particles"]):
            shard_devices = [s.device.id for s in leaf.addressable_shards]
            if count > 1 and leaf.ndim and leaf.shape[-1] >= count:
                assert len(set(shard_devices)) == count, (leaf.shape, shard_devices)

    rows, fields = {}, {}
    for shape in ((1, 1), (n_devices, 1), (2, n_devices // 2)):
        settings = invariance_settings()
        sim = DistributedSimulation2D(settings, mesh_shape=shape)
        check_placement(sim, shape[0] * shape[1])
        sim.particulator.set_flag("collision_enable", False)
        sim.run(3)
        sim.particulator.block_until_ready()
        rows[shape] = canonical_particles(sim, settings)
        fields[shape] = {f: _global_field(sim, settings, f) for f in ("thd", "qv", "RH")}
    truth = rows[(1, 1)]
    for shape in ((n_devices, 1), (2, n_devices // 2)):
        got = rows[shape]
        assert got.shape == truth.shape, (shape, got.shape, truth.shape)
        np.testing.assert_array_equal(got[:, 0], truth[:, 0])
        np.testing.assert_array_equal(got[:, 4], truth[:, 4])
        pos = float(np.max(np.abs(got[:, 1:3] - truth[:, 1:3])))
        wm = float(np.max(np.abs(got[:, 3] - truth[:, 3])))
        rel = {
            f: float(np.max(np.abs(fields[shape][f] - fields[(1, 1)][f])
                            / np.abs(fields[(1, 1)][f])))
            for f in ("thd", "qv", "RH")
        }
        log(f"mesh {shape} vs 1 shard: position {pos:.3g}, water mass {wm:.3g}, {rel}")
        assert pos < 1e-3 and wm < 1e-13 and max(rel.values()) < 1e-6

    settings = Settings(
        Formulae(seed=44),
        grid=big_grid,
        size=(1500 * si.m * big_grid[0] / big_grid[1], 1500 * si.m),
        n_sd_per_gridbox=n_sd_per_gridbox,
        spin_up_time=0,
    )
    sim = DistributedSimulation2D(
        settings, n_shards=n_devices, backend_class=TPU
    )
    check_placement(sim, n_devices)
    t0 = time.perf_counter()
    sim.run(2)
    sim.particulator.block_until_ready()
    mult = np.asarray(sim.particulator.particles.multiplicity)
    assert (mult >= 0).all()
    assert np.asarray(
        sim.particulator.sim_state["counters"]["condensation_success"]
    ).all()
    log(f"{big_grid[0]}x{big_grid[1]} grid, {settings.n_sd} SDs on "
        f"{n_devices} devices: 2 steps in {time.perf_counter() - t0:.1f} s "
        "(compile included)")


def main(argv):
    four = "--four-gpus" in argv
    devices = require_gpus(4 if four else 1)
    sys.path.insert(0, ROOT)
    from pysdm_tpu.utils.compile_cache import enable_compile_cache

    log("compile cache:", enable_compile_cache())
    if four:
        phase_four_gpus()
        count = 4
    else:
        phase_kernel()
        phase_parity()
        phase_main_path()
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
