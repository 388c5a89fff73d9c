"""Compile-cache directory resolution (dlaf_jax/cache.py): a fixed
directory inside the checkout, or none at all when the environment names
one."""
import os
import subprocess
import sys

import pytest

from dlaf_jax import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from dlaf_jax.cache import cache_dir, "
          "configure_compilation_cache as c; "
          "print(cache_dir()); print(c()); "
          "print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir=None):
    env = {k: v for k, v in os.environ.items() if k != cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env[cache.ENV_VAR] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-3:]


@pytest.mark.parametrize("cpu", [False, True])
def test_unset_is_fixed_inside_checkout(monkeypatch, cpu):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.cache_dir(cpu=cpu)
    assert os.path.commonpath([path, ROOT]) == ROOT
    top = ".jax_cache_cpu" if cpu else ".jax_cache"
    assert os.path.relpath(path, ROOT).split(os.sep)[0] == top
    assert cache.cache_dir(cpu=cpu) == path     # no pid, time or temp name


def test_set_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir(cpu=True) is None
    assert cache.cache_dir(cpu=False) is None


def test_set_variable_is_not_overridden_in_a_process(tmp_path):
    helper, used, config = _probe(str(tmp_path))
    assert helper == "None"
    assert used == str(tmp_path) == config


def test_same_path_from_two_processes():
    first, second = _probe(), _probe()
    assert first == second
    helper, used, config = first
    assert helper == used == config
    assert os.path.commonpath([used, ROOT]) == ROOT
