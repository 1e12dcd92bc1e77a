"""Committed parity-trace replay: the engine must
reproduce tests/data/parity_traces.json bit-for-bit-deterministically
(box multiplicities exact, parcel thermodynamics to f64 reproducibility).
The same file drives tools/reference_replay.py against the actual PySDM
wherever it is installable; see tools/make_parity_traces.py for the
stream-pinning construction that makes the two engines' croupiers
enumerate identical candidate pairs."""

import json
import os

import numpy as np

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "parity_traces.json",
)


def test_parcel_trace_replay():
    import tools_shim  # noqa: F401  (adds tools/ to sys.path)
    from make_parity_traces import run_parcel_ours

    with open(DATA) as f:
        block = json.load(f)["parcel"]
    case = dict(block["case"])
    steps = run_parcel_ours(case)
    for got, exp in zip(steps, block["expected"]):
        for key in ("thd", "qv", "RH"):
            np.testing.assert_allclose(got[key], exp[key], rtol=1e-12)
        np.testing.assert_allclose(
            got["radii_um"], exp["radii_um"], rtol=1e-10
        )


def test_box_trace_replay():
    import tools_shim  # noqa: F401
    from make_parity_traces import run_box_ours

    with open(DATA) as f:
        block = json.load(f)["box"]
    steps = run_box_ours(dict(block["case"]))
    for got, exp in zip(steps, block["expected"]):
        assert got["multiplicity"] == exp["multiplicity"]
        np.testing.assert_allclose(got["volume"], exp["volume"], rtol=1e-12)


def test_warmrain_mini_trace_replay():
    """all-four-dynamics mini warm-rain self-regression: the committed
    multi-step trajectory (incl. the seeded stochastic collision path)
    must reproduce exactly on the CPU f64 backend"""
    import tools_shim  # noqa: F401
    from make_parity_traces import run_warmrain_mini_ours

    with open(DATA) as f:
        block = json.load(f)["warmrain_mini"]
    steps = run_warmrain_mini_ours(dict(block["case"]))
    for got, exp in zip(steps, block["expected"]):
        for key in ("thd", "qv", "mult_sorted_by_dryv", "wm_sorted_by_dryv"):
            np.testing.assert_allclose(
                got[key], exp[key], rtol=1e-12, atol=1e-300
            )
