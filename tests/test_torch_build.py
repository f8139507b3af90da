"""The CUDA build's cache key (``kernels/build.py``), on the CPU.

A kernel's library is named by a hash of what its compile reads: its
own source, every header in ``csrc/`` and the full flag list.  Editing
any of them must name a new library, so a stale build is never loaded.
No ``nvcc`` is needed: only the names are computed.
"""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    monkeypatch.setattr(build, "CSRC", dst)
    return dst


def _edit(path):
    path.write_text(path.read_text() + "\n// edited\n")


@pytest.mark.parametrize("name", sorted(build.SOURCES))
@pytest.mark.parametrize("edit", ["own source", "hopper.cuh", "common.cuh",
                                  "new header"])
def test_library_path_changes_with_source_and_headers(csrc, name, edit):
    before = build._library_path(name)
    assert before == build._library_path(name)      # deterministic
    if edit == "own source":
        _edit(csrc / build.SOURCES[name])
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        _edit(csrc / edit)
    after = build._library_path(name)
    assert after != before
    assert after.parent == before.parent == build.BUILD_DIR


def test_library_path_ignores_other_kernels_sources(csrc):
    before = {n: build._library_path(n) for n in build.SOURCES}
    _edit(csrc / build.SOURCES["join_count"])
    after = {n: build._library_path(n) for n in build.SOURCES}
    assert after.pop("join_count") != before.pop("join_count")
    assert after == before


@pytest.mark.parametrize("extra", [("-I/usr/local/cutlass/include",),
                                   ("-lineinfo",)])
def test_library_path_changes_with_flags(csrc, monkeypatch, extra):
    before = {n: build._library_path(n) for n in build.SOURCES}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + extra)
    for n in build.SOURCES:
        assert build._library_path(n) != before[n]
