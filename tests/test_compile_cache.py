"""Persistent compile cache location: JAX_COMPILATION_CACHE_DIR when set,
else a fixed directory inside the checkout."""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after_import(env):
    code = ("import quantum_basis_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def test_compile_cache_honours_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_after_import(
        _env(JAX_COMPILATION_CACHE_DIR=want)) == want


def test_compile_cache_defaults_to_fixed_checkout_path():
    assert _cache_dir_after_import(_env()) == os.path.join(ROOT, ".xla_cache")
