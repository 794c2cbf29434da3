"""chip_smoke.py's contract where there is no GPU, and the compile-cache placement."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke
from kwave_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("argv", [[], ["--multi"]], ids=["one_gpu", "multi"])
def test_refuses_without_a_gpu(argv, capsys, cache_config):
    """On the CPU (as the tests run) it exits non-zero and prints no result line."""
    rc = chip_smoke.main(argv)
    out, err = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out
    assert "no GPU" in err


def test_multi_selects_only_its_phase():
    assert chip_smoke.phases_for(True) == ["multi"]
    one = chip_smoke.phases_for(False)
    assert "multi" not in one and {"main", "codec", "fields"} == set(one)
    assert set(chip_smoke.PHASES) == set(one) | {"multi"}


def test_fails_outside_a_checkout(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo: non-zero exit,
    no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_defaults_to_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("TMPDIR", "/nonexistent-tmp")
    first = compile_cache.enable()
    assert first == ROOT / ".jax_cache" == compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == tmp_path
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None
