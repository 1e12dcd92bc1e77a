"""What the program needs to start: the compile-cache location, no
optional packages on the import path, and ``chip_smoke.py`` — which must
refuse to run without a GPU, and whose phases run here on the CPU at tiny
sizes (the kernel in interpret mode, the four-card path on four virtual
CPU devices)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from pysdm_tpu.utils.compile_cache import (  # noqa: E402
    compile_cache_dir, enable_compile_cache,
)


def test_compile_cache_honours_the_variable(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache_dir() == str(tmp_path / "cache")
    assert enable_compile_cache() == str(tmp_path / "cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_repo_root(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(REPO_ROOT, ".jax_cache")


def _python(code_or_args, cwd, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    args = (
        ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    )
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout, check=False,
    )


def test_box_builds_and_runs_without_flax():
    proc = _python(
        "import sys\n"
        "sys.modules['flax'] = None  # any import of flax now fails\n"
        "import bench\n"
        "particulator = bench.build_box(64)\n"
        "particulator.run(2)\n"
        "print('ran', particulator.n_steps)\n",
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ran 2" in proc.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    proc = _python([os.path.join(REPO_ROOT, "chip_smoke.py")], cwd=REPO_ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    proc = _python(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_phases_on_cpu():
    ratio = chip_smoke.phase_kernel(
        grid=(25, 25), n_sd_per_gridbox=8, n_steps=2, interpret=True
    )
    assert ratio <= 1
    worst = chip_smoke.phase_parity()
    assert worst["state"] <= chip_smoke.PARCEL_RTOL_STATE
    results = chip_smoke.phase_main_path(
        steps={"box": 2, "parcel": 2, "breakup": 2, "warm_rain": 2},
        sizes={
            "box": {"n_sd": 2**10},
            "parcel": {"n_sd": 2**8},
            "breakup": {"n_sd": 2**8},
            "warm_rain": {"grid": (25, 25), "n_sd_per_gridbox": 8},
        },
    )
    assert set(results) == {"box", "parcel", "breakup", "warm_rain"}


def test_chip_smoke_four_device_phase_on_virtual_cpu_devices():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four_gpus(big_grid=(16, 8), n_sd_per_gridbox=16)


@pytest.mark.gpu
def test_kernel_matches_xla_on_the_card():
    """chip_smoke.py phase 1 at a reduced size, compiled for the card"""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check there")
    assert chip_smoke.phase_kernel(grid=(25, 25), n_sd_per_gridbox=64) <= 1
