"""The kernel build keeps nvcc's output beside its library.

``chip_smoke.py`` reads the ptxas lines of a build (registers, spills) from
``build.last_build["log"]``. A process that finds the library already built
by another (the card tests, a probe) must read the same lines: the build
writes them to ``<library>.log`` and a later load reads them from there.
Run with a stand-in for nvcc that writes its output files and prints a
ptxas line naming its source.
"""

import os
import stat

import pytest

pytest.importorskip("torch")

from blur_algorithms_tpu_torch.utils import build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
out=""
last=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; out="$1"; fi
  last="$1"
  shift
done
: > "$out"
echo "ptxas info    : Compiling entry function 'k_$(basename "$last" .cu)'"
echo "ptxas info    : Used 40 registers, 0 bytes spill stores"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    sources = []
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
        sources.append(tmp_path / name)
    return sources


def test_a_later_load_reads_the_builds_ptxas_lines(fake_toolchain):
    first, again = {}, {}
    lib = build._build_and_load(fake_toolchain, fake_toolchain, "libt", first)
    assert first["built"] and "Compiling entry function 'k_a'" in first["log"]
    assert "Compiling entry function 'k_b'" in first["log"]
    assert "Used 40 registers" in first["log"]
    log = build._log_path(build.build_dir() / os.path.basename(lib))
    assert log.read_text() == first["log"]
    # another process's load: the library is there, nothing is built
    assert build._build_and_load(fake_toolchain, fake_toolchain, "libt", again) == lib
    assert not again["built"] and again["log"] == first["log"]
    # the build leaves the library and its log, no temporary directory
    assert sorted(p.name for p in build.build_dir().iterdir()) == sorted(
        [os.path.basename(lib), log.name])


def test_a_library_without_its_log_loads_with_no_lines(fake_toolchain):
    rec = {}
    lib = build._build_and_load(fake_toolchain, fake_toolchain, "libt", rec)
    build._log_path(build.build_dir() / os.path.basename(lib)).unlink()
    rec = {}
    assert build._build_and_load(fake_toolchain, fake_toolchain, "libt", rec) == lib
    assert not rec["built"] and rec["log"] == ""
