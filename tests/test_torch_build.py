"""runtime/build.py without a card: a stand-in nvcc (a shell script that
prints ptxas lines and links an empty shared library with g++) shows that a
library served from the build directory reports the ptxas lines of the
build that made it, as a fresh build does."""
import os
import shutil
import stat

import pytest

from lighthouse_tpu_torch.runtime import build

PTXAS = """ptxas info    : Compiling entry function 'k' for 'sm_90a'
ptxas info    : Function properties for k
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]
"""

FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
cat <<'LINES'
{lines}LINES
exec {cxx} -shared -fPIC -x c++ /dev/null -o "$out"
"""


def test_cached_build_reports_its_ptxas_lines(tmp_path, monkeypatch):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to link the stand-in libraries")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(lines=PTXAS, cxx=cxx))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    want = build._parse_ptxas(PTXAS)
    assert len(want) == 2
    runs = []
    for _ in range(2):                 # a fresh build, then the cached one
        monkeypatch.setattr(build, "_LIBS", {})
        monkeypatch.setattr(build, "BUILD_INFO", {})
        runs.append(build.build_all())
    fresh, cached = runs
    assert set(fresh) == set(cached) == set(build.KERNELS)
    for name in build.KERNELS:
        assert not fresh[name]["cached"] and cached[name]["cached"]
        assert fresh[name]["ptxas"] == cached[name]["ptxas"] == want, name
    assert os.listdir(tmp_path / "build")
