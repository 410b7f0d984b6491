"""Process-level contracts: the GPU-only entry points refuse the CPU, and
the persistent compilation cache follows ``JAX_COMPILATION_CACHE_DIR``.

Each case runs a fresh interpreter: both contracts are decided when a
process starts (device discovery, the package's import-time config).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """With no GPU, the script exits non-zero before measuring anything
    and never prints a success line."""
    r = _run([script])
    assert r.returncode != 0, r.stdout[-2000:]
    assert '"ok": true' not in r.stdout
    assert '"metric"' not in r.stdout


_PRINT_CACHE = (
    "import divergence_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_env_var_wins(tmp_path):
    r = _run(["-c", _PRINT_CACHE],
             env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_default_in_checkout():
    """Without the variable the cache sits at a fixed directory inside
    the checkout, and git ignores it."""
    r = _run(["-c", _PRINT_CACHE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    cache = Path(r.stdout.strip().splitlines()[-1])
    assert cache == ROOT / ".jax_cache"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
