"""Persistent compilation cache: location, population, reuse, and the
off switch."""

import os
import subprocess
import sys

import pytest

from distance_tpu.utils import jitcache
from distance_tpu.utils.jitcache import enable_jit_cache

FASTA = b">a\nACGTACGTACGTACGT\n>b\nACGTACGTACGTTTTT\n>c\nAAGTACGTACGTACGT\n"


@pytest.fixture(autouse=True)
def _restore_jax_cache_config():
    """enable_jit_cache mutates process-wide jax config; restore it so
    tests running after this module don't inherit a persistent-cache
    config pointed at a deleted pytest tmp dir (the very configuration
    jitcache's docstring warns risks SIGILL on XLA:CPU reload)."""
    import jax

    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_enable_compilation_cache",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_enable_returns_dir_and_sets_config(tmp_path, monkeypatch):
    d = tmp_path / "jit"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    assert enable_jit_cache() == str(d)
    assert d.is_dir()
    import jax

    assert jax.config.jax_compilation_cache_dir == str(d)


def test_env_dir_wins_over_default_on_accelerator(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is honoured on an accelerator too, and
    the in-checkout default directory is neither set nor created."""
    import jax

    d = tmp_path / "env_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    monkeypatch.setattr(jitcache, "DEFAULT_DIR", str(tmp_path / "default"))
    monkeypatch.setattr(jitcache, "_on_accelerator", lambda: True)
    assert enable_jit_cache() == str(d)
    assert jax.config.jax_compilation_cache_dir == str(d)
    assert not (tmp_path / "default").exists()


def test_disabled_by_jax_switch(tmp_path, monkeypatch):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jit"))
    jax.config.update("jax_enable_compilation_cache", False)
    assert enable_jit_cache() is None
    assert not (tmp_path / "jit").exists()


def test_default_location_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    # accelerator platform: default-on, at the fixed in-checkout path
    monkeypatch.setattr(jitcache, "_on_accelerator", lambda: True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert enable_jit_cache() == os.path.join(repo, ".jax_cache")


def test_default_path_same_in_two_processes():
    """The default directory is fixed: two processes (different pids,
    start times and temp dirs) resolve the same path."""
    code = (
        "from distance_tpu.utils.jitcache import enable_jit_cache;"
        "print(enable_jit_cache())"
    )
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    # JAX_PLATFORMS only selects the cache policy here: nothing compiles
    env["JAX_PLATFORMS"] = "cuda"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [
        subprocess.run(
            [sys.executable, "-c", code], capture_output=True, env=env,
            cwd=repo, timeout=120, check=True,
        ).stdout.decode().strip()
        for _ in range(2)
    ]
    assert outs[0] == outs[1] == os.path.join(repo, ".jax_cache")


def test_default_off_on_cpu(tmp_path, monkeypatch):
    # XLA:CPU AOT executables are machine-specific (reload prints
    # feature-mismatch errors / risks SIGILL), so the cache must stay
    # off by default there; JAX_COMPILATION_CACHE_DIR opts in.
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert not jitcache._on_accelerator()
    assert enable_jit_cache() is None
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jit"))
    assert enable_jit_cache() == str(tmp_path / "jit")


def _run_cli(args, cache_dir, input_data):
    env = dict(
        os.environ,
        JAX_COMPILATION_CACHE_DIR=str(cache_dir),
        JAX_PLATFORMS="cpu",
    )
    return subprocess.run(
        [sys.executable, "-m", "distance_tpu.cli"] + args,
        input=input_data, capture_output=True, env=env,
    )


def test_cli_populates_cache_and_reuses(tmp_path):
    cache = tmp_path / "jit"
    r1 = _run_cli(["-m", "raw", "--backend", "xla"], cache, FASTA)
    assert r1.returncode == 0, r1.stderr
    entries = set(os.listdir(cache))
    assert entries, "first run should write compiled executables"
    r2 = _run_cli(["-m", "raw", "--backend", "xla"], cache, FASTA)
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout == r1.stdout
    # a hot second run adds no new entries for the same shapes/measure
    assert set(os.listdir(cache)) == entries
