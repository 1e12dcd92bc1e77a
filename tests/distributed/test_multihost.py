"""Multi-host distribution test: 2 processes x 4 emulated CPU devices over
localhost Gloo run the same x-slab-decomposed 2D warm-rain case as the
single-process 8-device smoke test (``tests/smoke/test_distributed_2d.py``)
— water budget must close and both processes must agree on the global
diagnostics (SURVEY.md §2.5 multi-host row; BASELINE multi-host target)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_worker_multihost.py")
N_STEPS = 12


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(n_steps, *extra_args):
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(WORKER)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), port, str(n_steps), *extra_args],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
        line = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    return outs


@pytest.fixture(scope="module")
def worker_outputs():
    return _run_workers(N_STEPS)


def test_two_process_runs_and_conserves_water(worker_outputs):
    for out in worker_outputs:
        before, after = out["before"], out["after"]
        assert after["condensation_ok"] == 1.0
        assert after["migration_dropped"] == 0.0
        np.testing.assert_allclose(
            after["water_total"], before["water_total"], rtol=1e-3
        )
        assert after["n_alive"] > 0.9 * before["n_alive"]


def test_two_process_sustained_crosswind_migration():
    """40 steps of courant_x ~0.85 crosswind on the process-spanning mesh:
    particles cross the Gloo process boundary repeatedly at near-capacity
    migration pressure; the ring exchange must deliver every mover and the
    global water budget must close on BOTH processes (the multi-host path
    needs a longer-than-12-step horizon under load)"""
    outs = _run_workers(40, "crosswind")
    for out in outs:
        before, after = out["before"], out["after"]
        assert after["condensation_ok"] == 1.0
        assert after["migration_dropped"] == 0.0
        np.testing.assert_allclose(
            after["water_total"], before["water_total"], rtol=1e-3
        )
        assert after["n_alive"] > 0.9 * before["n_alive"]
    # both processes must agree on the global state exactly
    np.testing.assert_allclose(
        outs[0]["after"]["water_total"], outs[1]["after"]["water_total"],
        rtol=1e-12,
    )


def test_processes_agree_on_global_state(worker_outputs):
    a, b = worker_outputs
    assert a["process_id"] != b["process_id"]
    for key in a["after"]:
        np.testing.assert_allclose(
            a["after"][key], b["after"][key], rtol=0, atol=0,
            err_msg=f"processes disagree on {key}",
        )
