"""``stardis_tpu_torch.util.compile_cache`` (the counterparts of
tests/test_compile_cache.py): without ``STARDIS_COMPILE_CACHE`` it does
nothing; an explicit directory beats the environment variable, and a later
call from the entry points' wiring keeps it; the entry points follow the
variable; the cache is filled and then hit, shown with the g++ VALD
parser's build on the CPU; and the CLI takes ``--compile-cache DIR`` with
the same spectrum as without it."""

import shutil

import numpy as np
import pytest
import torch

from stardis_tpu_torch import _cuda, native, run_stardis
from stardis_tpu_torch import units as tu
from stardis_tpu_torch.__main__ import main
from stardis_tpu_torch.io.synthetic import write_marcs_file, write_vald_linelist
from stardis_tpu_torch.opacities.lines import synth_linelist
from stardis_tpu_torch.atom_data import build_builtin_atom_data
from stardis_tpu_torch.util.compile_cache import ENV_VAR, enable_compilation_cache
from stardis_tpu_torch.util.regression import golden_config


@pytest.fixture(autouse=True)
def _restore_build_dirs(monkeypatch):
    """Leave both build directories as they were."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", _cuda.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.delenv(ENV_VAR, raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core each would oversubscribe the CPU many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_noop_without_env():
    before = (_cuda.BUILD_DIR, native.BUILD_DIR)
    assert enable_compilation_cache() is None
    assert (_cuda.BUILD_DIR, native.BUILD_DIR) == before == (_cuda.DEFAULT_BUILD_DIR,) * 2


def test_explicit_path_beats_env(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "env"))
    explicit = tmp_path / "explicit"
    assert enable_compilation_cache(explicit) == str(explicit)
    assert explicit.is_dir()
    assert _cuda.BUILD_DIR == native.BUILD_DIR == explicit
    # a later call without a directory (the entry points' wiring) keeps it
    assert enable_compilation_cache() == str(explicit)
    assert _cuda.BUILD_DIR == native.BUILD_DIR == explicit
    assert not (tmp_path / "env").exists()


def test_entry_points_follow_the_env(tmp_path, monkeypatch):
    cache = tmp_path / "env_cache"
    monkeypatch.setenv(ENV_VAR, str(cache))
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    run_stardis(golden_config("solar_halpha", model), tu.Quantity(np.arange(6560.0, 6562.0, 0.1),
                                                                   tu.AA),
                device="cpu", dtype=torch.float64)
    assert cache.is_dir() and _cuda.BUILD_DIR == native.BUILD_DIR == cache


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the VALD parser")
def test_cache_populated_and_hit(tmp_path, monkeypatch):
    """The parser's build lands in the cache; a process that loads it again
    (the loaded library forgotten) finds it there and runs no compiler."""
    cache = tmp_path / "cache"
    monkeypatch.setenv(ENV_VAR, str(cache))
    assert enable_compilation_cache() == str(cache)
    lines = synth_linelist(build_builtin_atom_data(8), 50).linelist_atoms
    vald = tmp_path / "lines.txt"
    write_vald_linelist(vald, lines)
    monkeypatch.setattr(native, "_lib_handle", None)
    table, _ = native.read_vald_linelist(vald)
    assert native.LAST_PARSER == "native"
    entries = sorted(p.name for p in cache.iterdir())
    assert len(entries) == 1 and entries[0].startswith("libvald_parser_")

    compiles, run = [], native.subprocess.run

    def counted(cmd, *args, **kwargs):
        compiles.append(cmd)
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native.subprocess, "run", counted)
    again, _ = native.read_vald_linelist(vald)
    monkeypatch.setattr(native.subprocess, "run", run)
    assert compiles == []
    assert native.LAST_PARSER == "native"
    assert sorted(p.name for p in cache.iterdir()) == entries
    for col in table.columns:
        np.testing.assert_array_equal(again[col], table[col])


def test_cli_compile_cache_flag(tmp_path):
    model = tmp_path / "sun.mod"
    write_marcs_file(model)
    cfg = tmp_path / "c.json"
    import json

    cfg.write_text(json.dumps(golden_config("solar_halpha", model)))
    outs = []
    for extra in ([], ["--compile-cache", str(tmp_path / "kernels")]):
        out = tmp_path / f"spec{len(outs)}.txt"
        assert main([str(cfg), "--lambda", "6560:6564:0.1", "--cpu", "--ascii", str(out),
                     *extra]) == 0
        outs.append(np.loadtxt(out))
    assert (tmp_path / "kernels").is_dir()
    assert _cuda.BUILD_DIR == tmp_path / "kernels"
    np.testing.assert_array_equal(outs[0], outs[1])
