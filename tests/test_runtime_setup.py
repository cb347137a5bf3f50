"""Where the program keeps its build outputs and caches, how it names the
device it runs on, and the chip smoke script's own contract."""

import json
import os
import shutil
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from rovinasemanticsegmentation_tpu import native
from rovinasemanticsegmentation_tpu.utils import compile_cache
from rovinasemanticsegmentation_tpu.utils.device import (
    parse_gpu_query,
    require_gpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ignored(path_in_repo):
    lines = open(os.path.join(ROOT, ".gitignore")).read().splitlines()
    return path_in_repo in lines or "/" + path_in_repo in lines


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_variable_wins_and_nothing_is_set(self, monkeypatch):
        monkeypatch.setenv(compile_cache.ENV, "/elsewhere/cache")
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert compile_cache.setup_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == "sentinel"

    def test_default_is_inside_the_checkout(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        path = compile_cache.setup_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.dirname(path) == ROOT

    def test_default_is_ignored_by_git(self):
        name = os.path.basename(compile_cache.DEFAULT_DIR) + "/"
        assert _ignored(name)


class TestNativeBuild:
    def test_library_name_is_keyed_by_source_hash(self):
        path = native.lib_path()
        assert os.path.dirname(path) == native.BUILD_DIR
        assert native.source_hash() in os.path.basename(path)
        rel = os.path.relpath(native.BUILD_DIR, ROOT) + "/"
        assert _ignored(rel)

    def test_hash_follows_the_sources(self, tmp_path, monkeypatch):
        for name in native._SOURCES:
            shutil.copy(os.path.join(native._DIR, name), tmp_path / name)
        monkeypatch.setattr(native, "_DIR", str(tmp_path))
        before = native.source_hash()
        with open(tmp_path / native._SOURCES[0], "a") as f:
            f.write("\n// changed\n")
        assert native.source_hash() != before

    def test_builds_from_source(self, tmp_path, monkeypatch):
        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler")
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        lib = native.get_lib()
        assert lib is not None
        assert os.path.exists(native.lib_path())
        assert os.listdir(tmp_path / "build") == [
            os.path.basename(native.lib_path())
        ]
        assert native.native_forest_decode(b"\x00" * 3) is None

    def test_no_compiled_library_beside_the_sources(self):
        for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "rovinasemanticsegmentation_tpu")
        ):
            if os.path.abspath(dirpath).startswith(native.BUILD_DIR):
                continue
            assert not [f for f in filenames if f.endswith(".so")], dirpath


class TestDeviceDescription:
    def test_refuses_the_cpu(self):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            require_gpu()

    @pytest.mark.parametrize("text,cards", [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 700.00 W\n" * 4,
         [("NVIDIA H100 80GB HBM3", "700.00 W")] * 4),
        ("Some, Card, With Commas, 350.00 W",
         [("Some, Card, With Commas", "350.00 W")]),
    ])
    def test_parses_nvidia_smi(self, text, cards):
        assert parse_gpu_query(text) == cards

    def test_rejects_unexpected_output(self):
        with pytest.raises(ValueError):
            parse_gpu_query("no comma here")


class TestChipSmoke:
    def test_last_line_format(self):
        sys.path.insert(0, ROOT)
        import chip_smoke

        line = chip_smoke.result_line(
            {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
             "extra": "dropped"}
        )
        assert "\n" not in line
        assert json.loads(line) == {
            "ok": True,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1},
        }

    def test_refuses_the_cpu_before_any_result(self, capsys):
        sys.path.insert(0, ROOT)
        import chip_smoke

        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out

    def test_fails_alone_in_a_directory(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
