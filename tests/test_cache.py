"""The persistent compile cache's one helper (utils/cache.py)."""

from pathlib import Path

import jax
import pytest

from phys_autodiff_tpu.utils import cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_is_honoured_as_is(monkeypatch, restore_cache_dir,
                                        tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
    assert cache.enable_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_default_is_the_checkout_build_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV, raising=False)
    path = cache.enable_compile_cache()
    assert path == str(ROOT / "build" / "jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_empty_env_variable_counts_as_unset(monkeypatch, restore_cache_dir):
    monkeypatch.setenv(cache.ENV, "")
    assert cache.enable_compile_cache() == str(ROOT / "build" / "jax_cache")


def test_default_does_not_depend_on_the_working_directory(monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    assert cache.default_cache_dir() == ROOT / "build" / "jax_cache"
    assert cache.default_cache_dir().is_absolute()


def test_cli_turns_the_cache_on(monkeypatch):
    from phys_autodiff_tpu import cli

    seen = []
    monkeypatch.setattr(cache, "enable_compile_cache",
                        lambda: seen.append(1) or "x")
    monkeypatch.setitem(cli._COMMANDS, "info", lambda args: 0)
    assert cli.main(["info"]) == 0
    assert seen == [1]


def test_no_program_file_hard_codes_a_cache_path():
    files = list(ROOT.glob("*.py")) + list((ROOT / "scripts").glob("*.py")) + \
        list((ROOT / "phys_autodiff_tpu").rglob("*.py"))
    for p in files:
        text = p.read_text()
        assert "jax_compilation_cache_dir" not in text or p.name == "cache.py", p
        assert "/root/" not in text, p
