"""The kernel build's digest: a library is reused only while every source
and every header the sources include is unchanged (no nvcc needed)."""

import glob
import os
import re
import shutil

import pytest

from aligntools_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", str(dst))
    return dst


@pytest.mark.parametrize("name", ["block_scan.cuh", "blocked_fill.cu",
                                  "ptr_fill.cu"])
def test_library_path_changes_with_each_file(csrc_copy, name):
    before = _build.library_path()
    with open(csrc_copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


def test_local_includes_are_digested_headers():
    """Every quoted include of a kernel source is a csrc/*.cuh, which the
    digest covers."""
    headers = {os.path.basename(p)
               for p in glob.glob(os.path.join(_build.CSRC, "*.cuh"))}
    seen = set()
    for src in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(src) as f:
            seen.update(re.findall(r'#include "([^"]+)"', f.read()))
    assert seen and seen <= headers
