"""Entry-point contracts: the package imports without optional packages,
the compile cache follows JAX_COMPILATION_CACHE_DIR or stays in the
checkout, and the GPU-only entry points refuse to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=ROOT, timeout=240):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("XLA_FLAGS", None)
    args = code_or_args if isinstance(code_or_args, list) else [
        sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize(
    "module", ["aruco_slam_tpu.runner", "aruco_slam_tpu.system"]
)
def test_import_without_yaml(module):
    """PyYAML is optional: only load_config on a file needs it."""
    r = _run(
        "import sys; sys.modules['yaml'] = None\n"
        f"import {module}\n"
        "from aruco_slam_tpu.utils.config import load_config\n"
        "cfg = load_config({'ekf': {'max_landmarks': 8}})\n"
        "assert cfg.ekf.max_landmarks == 8\n"
        "print('OK')"
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


@pytest.mark.parametrize("set_var", [True, False], ids=["env", "default"])
def test_compile_cache_dir(set_var, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper uses it and nothing
    else; unset, it uses the checkout's .jax_cache/ (listed in
    .gitignore)."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_var else {}
    if not set_var:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run(
        "import jax\n"
        "from aruco_slam_tpu.utils.compile_cache import enable_compile_cache\n"
        "p = enable_compile_cache()\n"
        "print(p); print(jax.config.jax_compilation_cache_dir)",
        env_extra=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    got, cfg_dir = r.stdout.split()[-2:]
    want = str(tmp_path) if set_var else os.path.join(ROOT, ".jax_cache")
    assert got == cfg_dir == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "ok" in obj), line


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """Device measurements are taken on a GPU or not at all: without one
    the script exits non-zero and prints no result line."""
    r = _run([sys.executable, script])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    _no_result(r.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repository
    fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    _no_result(r.stdout)
