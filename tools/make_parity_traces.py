"""Generate the committed parity traces (tests/data/parity_traces.json).

The trace file is the INTERFACE between this engine and the reference:
it carries the full case definition (initial per-particle attributes,
environment parameters, pinned/injected u01 streams) plus the per-step
expected state produced by THIS engine in float64. ``tools/
reference_replay.py`` consumes the same file on any machine where the
actual PySDM (+numba) is installed, rebuilds the identical case through
the PySDM API, injects the identical streams, and reports step-by-step
diffs — the BASELINE.json "seeded allclose vs PySDM" comparison.
``tests/unit/test_parity_traces.py`` replays the file against this engine
(regression pinning + determinism of the generator).

Stream pinning (single cell, reference "local" croupier semantics,
``index_methods.py:33-44``): shuffle u01[i] = (i + 0.5)/n makes the
reference Fisher-Yates the identity permutation, and the same ascending
values make this engine's sort croupier the identity too — so both
engines enumerate the same candidate pairs (slots (2i, 2i+1)), and the
committed per-pair gamma draws land on the same pairs
(reference ``compute_gamma`` consumes rand[i] for pair i,
``collisions_methods.py:522-560``; this engine consumes the leader-slot
entry of a per-slot array: ours[2i] = ref[i]).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_STEPS_PARCEL = 20
N_STEPS_BOX = 8


def parcel_case():
    """adiabatic parcel, fixed 10 substeps (adaptivity pinned so both
    engines integrate the same path; residual diffs = root-finder
    tolerance rtol_x)."""
    n_sd = 32
    r_dry = np.logspace(np.log10(10e-9), np.log10(300e-9), n_sd)
    weights = np.exp(-((np.log(r_dry / 75e-9)) ** 2) / (2 * 0.6**2))
    multiplicity = np.round(weights / weights.sum() * 1e10 + 1).astype(
        np.int64
    )
    return {
        "env": {
            "dt": 1.0,
            "mass_of_dry_air": 1e3,
            "p0": 100000.0,
            "initial_water_vapour_mixing_ratio": 0.011,
            "T0": 290.0,
            "w": 2.5,
        },
        "formulae": {"seed": 44},
        "condensation": {"adaptive": False, "substeps": 10,
                         "rtol_x": 1e-6, "rtol_thd": 1e-6},
        "kappa": 0.6,
        "n_sd": n_sd,
        "r_dry": r_dry.tolist(),
        "multiplicity": multiplicity.tolist(),
        "n_steps": N_STEPS_PARCEL,
    }


def box_case():
    n_sd = 16
    rng = np.random.default_rng(1234)
    volume = np.sort(rng.uniform(5e-13, 5e-11, n_sd))
    multiplicity = rng.integers(5, 5000, n_sd).astype(np.int64)
    shuffle = ((np.arange(n_sd) + 0.5) / n_sd).tolist()
    gamma_rand = rng.uniform(0.0, 1.0, (N_STEPS_BOX, n_sd // 2))
    return {
        "env": {"dt": 1.0, "dv": 1.0},
        "formulae": {"seed": 44},
        "kernel": {"type": "ConstantK", "a": 3e-5},
        "n_sd": n_sd,
        "volume": volume.tolist(),
        "multiplicity": multiplicity.tolist(),
        "shuffle_u01": shuffle,
        "gamma_rand": gamma_rand.tolist(),
        "n_steps": N_STEPS_BOX,
    }


def run_parcel_ours(case):
    from pysdm_tpu import Builder, Formulae
    from pysdm_tpu.backends import CPU
    from pysdm_tpu.dynamics import AmbientThermodynamics, Condensation
    from pysdm_tpu.environments import Parcel
    from pysdm_tpu.initialisation import equilibrate_wet_radii

    formulae = Formulae(**case["formulae"])
    env = Parcel(**case["env"])
    builder = Builder(
        n_sd=case["n_sd"], backend=CPU(formulae), environment=env
    )
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(**case["condensation"]))
    r_dry = np.asarray(case["r_dry"])
    v_dry = formulae.trivia.volume(radius=r_dry)
    kappa = case["kappa"]
    r_wet = equilibrate_wet_radii(
        r_dry=r_dry,
        environment=builder.particulator.environment,
        kappa_times_dry_volume=kappa * v_dry,
    )
    attributes = {
        "multiplicity": np.asarray(case["multiplicity"]),
        "dry volume": v_dry,
        "kappa times dry volume": kappa * v_dry,
        "volume": formulae.trivia.volume(radius=np.asarray(r_wet)),
    }
    particulator = builder.build(attributes)
    # the equilibrated initial volumes are part of the interface: the
    # reference replay initialises from THESE numbers, not its own
    # equilibration
    case["volume"] = np.asarray(attributes["volume"]).tolist()
    steps = []
    for _ in range(case["n_steps"]):
        particulator.run(1)
        steps.append(
            {
                "thd": float(particulator.get_env("thd")[0]),
                "qv": float(particulator.get_env("qv")[0]),
                "RH": float(particulator.get_env("RH")[0]),
                "radii_um": (
                    np.asarray(particulator.attributes["radius"]) * 1e6
                ).tolist(),
            }
        )
    return steps


def run_box_ours(case):
    from pysdm_tpu import Builder, Formulae
    from pysdm_tpu.backends import CPU
    from pysdm_tpu.dynamics import Coalescence
    from pysdm_tpu.dynamics.collisions.collision_kernels import ConstantK
    from pysdm_tpu.environments import Box

    formulae = Formulae(**case["formulae"])
    builder = Builder(
        n_sd=case["n_sd"],
        backend=CPU(formulae),
        environment=Box(dt=case["env"]["dt"], dv=case["env"]["dv"]),
    )
    builder.enable_u01_injection()
    builder.add_dynamic(
        Coalescence(
            collision_kernel=ConstantK(a=case["kernel"]["a"]),
            adaptive=False,
        )
    )
    attributes = {
        "multiplicity": np.asarray(case["multiplicity"]),
        "volume": np.asarray(case["volume"]),
    }
    particulator = builder.build(attributes)
    n_sd = case["n_sd"]
    steps = []
    for step in range(case["n_steps"]):
        gamma_ours = np.repeat(np.asarray(case["gamma_rand"][step]), 2)
        particulator.inject_u01(
            {
                "collision_shuffle": np.asarray(case["shuffle_u01"]),
                "collision_gamma": gamma_ours,
                "collision_process": np.zeros(n_sd),  # coalesce always
                "collision_fragmentation": np.zeros(n_sd),
            }
        )
        particulator.run(1)
        steps.append(
            {
                "multiplicity": np.asarray(
                    particulator.attributes["multiplicity"]
                ).astype(int).tolist(),
                "volume": np.asarray(
                    particulator.attributes["volume"]
                ).tolist(),
            }
        )
    return steps


def warmrain_mini_case():
    return {
        "grid": [8, 8],
        "size_m": [1500.0, 1500.0],
        "dt": 5.0,
        "n_sd_per_gridbox": 16,
        "formulae": {"seed": 31},
        "n_steps": 5,
    }


def run_warmrain_mini_ours(case):
    """full-physics mini warm-rain (ALL FOUR dynamics: condensation, MPDATA
    advection, displacement/sedimentation, coalescence) — an ENGINE
    self-regression trace: the collision stream is this engine's own
    seeded threefry chain, so the trace pins the complete multi-dynamic
    integration (incl. the stochastic path) against regressions, while the
    parcel/box cases above carry the cross-engine (PySDM-replayable)
    comparisons."""
    from pysdm_tpu.backends import CPU
    from pysdm_tpu.models.arabas_et_al_2015 import Settings, make_simulation
    from pysdm_tpu.physics import Formulae, si

    settings = Settings(
        Formulae(**case["formulae"]),
        grid=tuple(case["grid"]),
        size=(case["size_m"][0] * si.m, case["size_m"][1] * si.m),
        dt=case["dt"] * si.s,
        n_sd_per_gridbox=case["n_sd_per_gridbox"],
        spin_up_time=0,
    )
    particulator, spin_up = make_simulation(settings, backend_class=CPU)
    spin_up.finish()
    steps = []
    for _ in range(case["n_steps"]):
        particulator.run(1)
        mult = np.asarray(particulator.particles.multiplicity, np.float64)
        wm = np.asarray(
            particulator.particles.ext("signed water mass"), np.float64
        )
        order = np.argsort(
            np.asarray(particulator.particles.ext("dry volume"), np.float64),
            kind="stable",
        )
        steps.append(
            {
                "thd": np.asarray(particulator.get_env("thd")).tolist(),
                "qv": np.asarray(particulator.get_env("qv")).tolist(),
                "mult_sorted_by_dryv": mult[order].tolist(),
                "wm_sorted_by_dryv": wm[order].tolist(),
            }
        )
    return steps


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")  # the traces are CPU float64
    out_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "parity_traces.json",
    )
    parcel = parcel_case()
    parcel_steps = run_parcel_ours(parcel)
    box = box_case()
    box_steps = run_box_ours(box)
    wr = warmrain_mini_case()
    wr_steps = run_warmrain_mini_ours(wr)
    data = {
        "_provenance": (
            "generated by tools/make_parity_traces.py with pysdm_tpu on the "
            "CPU float64 backend; the 'expected' blocks become "
            "reference-verified once tools/reference_replay.py has been run "
            "against an actual PySDM install and its report committed"
        ),
        "parcel": {"case": parcel, "expected": parcel_steps},
        "box": {"case": box, "expected": box_steps},
        "warmrain_mini": {"case": wr, "expected": wr_steps},
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
