"""The kernel build of src/repro_torch/kernels/_build.py, without nvcc:
the library's name follows every source it compiles, the Hopper header
included, and nothing is built when the modules are imported."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    return Path(shutil.copytree(_build.CSRC, tmp_path / "csrc"))


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attention.cu",
                                  "grouped_ffn.cu"])
def test_editing_a_source_renames_the_library(csrc, tmp_path, name):
    before = _build.library_path(csrc, tmp_path)
    assert _build.library_path(csrc, tmp_path) == before
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(csrc, tmp_path)
    assert after != before and after.parent == tmp_path


def test_the_digest_covers_every_header_and_source(csrc, tmp_path):
    files = {p.name for p in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]}
    assert "hopper.cuh" in files and set(_build.SOURCES) <= files
    before = _build.library_path(csrc, tmp_path)
    (csrc / "new.cuh").write_text("#pragma once\n")
    assert _build.library_path(csrc, tmp_path) != before


def test_an_existing_library_is_reused_without_nvcc(csrc, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.library_path(csrc, tmp_path / "build")
    lib.parent.mkdir()
    lib.write_bytes(b"")

    def refuse(*a, **k):
        raise AssertionError("nvcc was started")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    assert _build.build() == lib


def test_importing_the_kernels_builds_nothing():
    """A fresh interpreter imports every kernel module and the model code
    with process creation and library loading refused (after torch, which
    loads its own libraries)."""
    code = """
import ctypes, subprocess, sys
import torch
def refuse(*a, **k):
    raise AssertionError("a build was started at import")
subprocess.Popen = subprocess.run = ctypes.CDLL = refuse
from repro_torch.kernels import (_build, decode_attention, flash_attention,
                                 grouped_matmul, ops, rmsnorm, ssd_scan,
                                 tokenweave)
import repro_torch.api, repro_torch.models.moe, repro_torch.models.hybrid
assert _build._LIB is None and not _build.BUILD_LOG
"""
    src = str(Path(_build.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _extern_c_functions(csrc: Path) -> dict:
    """{name: number of parameters} of every function defined in an
    ``extern "C"`` block of ``csrc/*.cu``."""
    found = {}
    for f in sorted(csrc.glob("*.cu")):
        text = f.read_text()
        for block in text.split('extern "C" {')[1:]:
            block = block.split('}  // extern "C"')[0]
            for name, params in re.findall(
                    r"^[A-Za-z][\w\s\*]*?\b(repro_\w+)\(([^)]*)\)", block,
                    re.M):
                params = params.strip()
                assert name not in found, f"{name} defined twice"
                found[name] = (0 if params in ("", "void")
                               else params.count(",") + 1)
    return found


def test_every_extern_c_function_has_a_signature_and_back():
    """Each entry point of the sources has a ctypes signature with as many
    arguments as it takes, and each signature names an entry point."""
    defined = _extern_c_functions(_build.CSRC)
    assert set(defined) == set(_build._SIGNATURES)
    for name, (args, _) in _build._SIGNATURES.items():
        assert len(args) == defined[name], name


def test_every_source_is_compiled():
    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
