"""The kernel build's digest: a library is reused only while every source
and every header the sources include is unchanged (no nvcc needed). And
the port's test files' one torch thread a pytest-xdist worker
(tests/torch_cpu.py)."""

import torch_cpu

import ast
import glob
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from aligntools_tpu_torch.ops import _build

TESTS = os.path.dirname(os.path.abspath(__file__))


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


def _imports(path):
    """The modules a file imports at its top level, in order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module)
    return names


def test_every_port_test_imports_torch_cpu_first():
    """Each tests/test_torch_*.py imports tests/torch_cpu.py before torch,
    the port, and any other port test file (which imports both)."""
    files = sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py")))
    assert len(files) > 20
    for path in files:
        names = _imports(path)
        assert "torch_cpu" in names, path
        before = [n for n in names[: names.index("torch_cpu")]
                  if n == "torch" or n.startswith(
                      ("torch.", "aligntools_tpu_torch", "test_torch_"))]
        assert not before, (path, before)


def test_one_torch_thread_under_a_worker():
    """Under pytest-xdist every port test runs on one torch thread, and
    the processes it spawns inherit OMP_NUM_THREADS."""
    worker = bool(os.environ.get("PYTEST_XDIST_WORKER"))
    assert torch_cpu.PINNED == worker
    if worker:
        assert torch.get_num_threads() == 1
        assert os.environ.get("OMP_NUM_THREADS")


@pytest.mark.parametrize("worker", ["gw0", None], ids=["worker", "alone"])
def test_torch_cpu_in_a_fresh_process(worker):
    """A fresh process: under a worker the helper pins one thread and sets
    OMP_NUM_THREADS=1; alone it leaves torch's threads and the environment
    as they were."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER", "OMP_NUM_THREADS")}
    if worker:
        env["PYTEST_XDIST_WORKER"] = worker
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); import torch; "
            "n = torch.get_num_threads(); import torch_cpu; "
            "print(n, torch.get_num_threads(), "
            "os.environ.get('OMP_NUM_THREADS'))")
    out = subprocess.run([sys.executable, "-c", code, TESTS], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    if worker:
        assert out[1:] == ["1", "1"]
    else:
        assert out == [out[0], out[0], "None"]
