"""The compile-cache rule (utils/jaxcache.py): JAX_COMPILATION_CACHE_DIR
wins, otherwise one fixed directory inside the checkout, and nothing is set
at import. Each case runs in a fresh interpreter, since the cache directory
is process-global JAX state."""

import os
import subprocess
import sys

import pytest

from magnetite_tpu.utils.jaxcache import CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env) -> str:
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    base.update(JAX_PLATFORMS="cpu", **env)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=base,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_default_dir_is_fixed_inside_the_checkout():
    assert CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_nothing_is_set_at_import():
    got = _run(
        "import jax, magnetite_tpu, magnetite_tpu.fem.solve, "
        "magnetite_tpu.parallel.sweep, magnetite_tpu.cli; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    assert got == "None"


def test_unset_env_lands_in_the_checkout():
    got = _run(
        "import jax; from magnetite_tpu.utils.jaxcache import "
        "enable_persistent_cache as e; d = e(); "
        "print(d == jax.config.jax_compilation_cache_dir, d)"
    )
    assert got == f"True {CACHE_DIR}"


@pytest.mark.parametrize("entry", ["enable_persistent_cache", "ensure_default_cache"])
def test_env_var_is_honoured(tmp_path, entry):
    got = _run(
        "import jax; from magnetite_tpu.utils import jaxcache; "
        f"jaxcache.{entry}(); print(jax.config.jax_compilation_cache_dir)",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path),
    )
    assert got == str(tmp_path)


def test_callers_choice_is_kept(tmp_path):
    got = _run(
        "import jax; from magnetite_tpu.utils.jaxcache import "
        "enable_persistent_cache as e; "
        f"jax.config.update('jax_compilation_cache_dir', {str(tmp_path)!r}); "
        "print(e())"
    )
    assert got == str(tmp_path)


def test_library_entry_points_leave_the_cpu_uncached():
    got = _run(
        "import jax; from magnetite_tpu.utils.jaxcache import "
        "ensure_default_cache as e; e(); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    assert got == "None"
